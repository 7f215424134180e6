"""dr_using_scv_od_tpu_torch: the PyTorch + CUDA port of dr_using_scv_od_tpu.

The JAX package beside it is the reference; this package imports torch and
numpy and never jax or flax, so it runs on a machine that has neither.
Module paths and public names mirror the JAX package.

Layer map (bottom-up):
  config   - typed profiles (a copy of the JAX package's config.py)
  types    - tensor containers with the JAX package's field names
  interop  - configs and streaming tracking state carried over from JAX
  ops      - geometry, quantization, segment reductions, clustering and the
             hand-written CUDA union-find kernel (ops/cluster_labels.py,
             csrc/cluster_labels.cu)
  models   - patchwork, segmentation, recognition, tracking, pipeline
  utils    - the synthetic scene generator (a copy)
  eval     - PR/RR/F1 removal metrics in numpy

Devices are explicit: functions on tensors work on the device of the
tensors they are given, and functions that build tensors from numpy take a
`device` argument. Nothing on the path draws random numbers.
"""

from . import config
from . import types

__version__ = "0.1.0"
