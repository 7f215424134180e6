"""dr_using_scv_od_tpu_torch: the PyTorch + CUDA port of dr_using_scv_od_tpu.

The JAX package beside it is the reference; this package imports torch and
numpy and never jax or flax, so it runs on a machine that has neither.
Module paths and public names mirror the JAX package.

Layer map (bottom-up):
  config   - typed profiles (a copy of the JAX package's config.py)
  types    - tensor containers with the JAX package's field names
  interop  - configs, streaming tracking state and GICP state carried
             over from JAX
  ops      - geometry, quantization, segment reductions, clustering and the
             three hand-written CUDA union-find kernels, built by
             ops/cuda_build.py from csrc/: cluster_labels (fused CC + RI3),
             cc_labels (CC) and ri3_labels (RI3), all on csrc/union_find.cuh
  models   - patchwork, segmentation, recognition, tracking, pipeline;
             gicp, posegraph.odometry_chain and odometry (window poses)
  tools    - profile_stages: per-component timing on one device
  utils    - the synthetic scene generator (a copy)
  eval     - PR/RR/F1 removal metrics in numpy

Devices are explicit: functions on tensors work on the device of the
tensors they are given, and functions that build tensors from numpy take a
`device` argument. Nothing on the path draws random numbers.
"""

from . import config
from . import types

__version__ = "0.1.0"
