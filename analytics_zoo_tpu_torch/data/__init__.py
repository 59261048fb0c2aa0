"""Host-side datasets feeding the estimator."""

from analytics_zoo_tpu_torch.data.featureset import (  # noqa: F401
    DeviceFeatureSet, DiskFeatureSet, FeatureSet)
from analytics_zoo_tpu_torch.data.cursor import (  # noqa: F401
    DataCursor, epoch_rng)
from analytics_zoo_tpu_torch.data.transforms import Transforms  # noqa: F401
from analytics_zoo_tpu_torch.data.sharded import (  # noqa: F401
    ShardSpec, ShardedFeatureSet, assign_shards, build_manifest,
    write_npz_shards)
