"""The benchmark's plain reference: a frozen copy of the port's plain
path (dr_using_scv_od_tpu_torch's config, types, ops and models that
`pipeline.run_window` and the SLAM engine reach), with kernel 1 replaced
by its plain PyTorch version (`ops/cluster_labels.py`).

It imports nothing of the port, of JAX or of the JAX package, and it takes
nothing the port has made: the drivers hand it the same inputs they hand
the port, and it works out every derived quantity and state itself. The
port may change after this copy was taken; the copy does not, so the
comparison that decides `correct` holds each later version of the port to
the semantics it had here. Edit nothing in this folder.

`build.py` turns a configuration file of `benchmark/configs/` into this
copy's config dataclasses.
"""
