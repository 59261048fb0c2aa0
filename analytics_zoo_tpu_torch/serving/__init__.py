"""Cluster Serving: the in-memory, native-queue and Redis brokers, the
queue and HTTP clients, the classic and pipelined engine, the HTTP
frontend, the journaled broker with its warm standby and the
multi-process fleet."""
from analytics_zoo_tpu_torch.serving.broker import (  # noqa: F401
    InMemoryBroker, NativeQueueBroker, RedisBroker, get_broker)
from analytics_zoo_tpu_torch.serving.client import (  # noqa: F401
    FASTWIRE_CONTENT_TYPE, FastWireHttpClient, InputQueue, OutputQueue,
    ServingDeadlineError, ServingError, ServingShedError)
from analytics_zoo_tpu_torch.serving.durability import (  # noqa: F401
    BrokerReplica, DurableBroker)
from analytics_zoo_tpu_torch.serving.engine import ClusterServing  # noqa: F401
from analytics_zoo_tpu_torch.serving.fleet import (  # noqa: F401
    BrokerBridge, FleetRouter, FleetSupervisor, RemoteBroker,
    ReplicaAutoscaler)
from analytics_zoo_tpu_torch.serving.model_zoo import (  # noqa: F401
    ModelEntry, ModelRegistry, PageInError, validate_model_name)
from analytics_zoo_tpu_torch.serving.tenancy import (  # noqa: F401
    TenancyController, TenantPolicy, WeightedScheduler)
