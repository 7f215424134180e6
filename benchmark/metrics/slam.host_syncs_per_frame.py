"""slam.host_syncs_per_frame: host-device synchronisations the port made
per frame in a profiled SLAM session (the host dispatch of
models/engine.py), as the port's recorder counts them
(program_record.profiled); nothing without a card."""

from benchmark import program_record


def read(ctx):
    return program_record.syncs_per_frame(
        program_record.profiled(ctx), ctx["profiled_frames"])
