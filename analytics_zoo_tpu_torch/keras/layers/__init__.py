"""The Keras layer catalogue: every name of the JAX package's
``keras/layers/__init__.py``, with its Keras-1 aliases."""

from analytics_zoo_tpu_torch.keras.engine import Input, Lambda, Layer
from analytics_zoo_tpu_torch.keras.layers.core import (
    Activation, AddConstant, BinaryThreshold, CAdd, CMul, Dense, Dropout,
    Exp, Expand, ExpandDim, Flatten, GaussianDropout, GaussianNoise,
    GaussianSampler, GetShape, HardShrink, HardTanh, Highway, Identity,
    KerasLayerWrapper, Log,
    LRN2D, Masking, Max, MaxoutDense, Merge, Mul, MulConstant, Narrow,
    Negative, Permute, Power, RepeatVector, Reshape, Scale, Select,
    SelectTable, SoftShrink, SparseDense, SpatialDropout1D, SpatialDropout2D,
    SpatialDropout3D, SplitTensor, Sqrt, Square, Squeeze, Threshold,
    WithinChannelLRN2D)
from analytics_zoo_tpu_torch.keras.layers.advanced_activations import (
    ELU, LeakyReLU, PReLU, RReLU, Softmax, SReLU, ThresholdedReLU)
from analytics_zoo_tpu_torch.keras.layers.normalization import (
    BatchNormalization, LayerNorm)
from analytics_zoo_tpu_torch.keras.layers.embedding import (
    Embedding, SparseEmbedding, WordEmbedding)
from analytics_zoo_tpu_torch.keras.layers.convolutional import (
    AtrousConvolution1D, AtrousConvolution2D, Convolution1D, Convolution2D,
    Convolution3D, Cropping1D, Cropping2D, Cropping3D, Deconvolution2D,
    LocallyConnected1D, LocallyConnected2D, ResizeBilinear,
    SeparableConvolution2D, ShareConv2D, ShareConvolution2D, UpSampling1D,
    UpSampling2D, UpSampling3D, ZeroPadding1D, ZeroPadding2D, ZeroPadding3D)
from analytics_zoo_tpu_torch.keras.layers.pooling import (
    AveragePooling1D, AveragePooling2D, AveragePooling3D,
    GlobalAveragePooling1D, GlobalAveragePooling2D, GlobalAveragePooling3D,
    GlobalMaxPooling1D, GlobalMaxPooling2D, GlobalMaxPooling3D, MaxPooling1D,
    MaxPooling2D, MaxPooling3D, Pooling1D, Pooling2D)
from analytics_zoo_tpu_torch.keras.layers.recurrent import (
    Bidirectional, ConvLSTM2D, ConvLSTM3D, GRU, LSTM, Recurrent, SimpleRNN,
    TimeDistributed)
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    BERT, MultiHeadAttention, PositionwiseFFN, TransformerBlock,
    TransformerLayer)

# Keras-1 aliases
Conv1D = Convolution1D
Conv2D = Convolution2D
Conv3D = Convolution3D

__all__ = sorted(n for n in dir() if n[0].isupper())
