"""removal.host_syncs_per_frame: host-device synchronisations the port made
per frame in a removal pool pass (the host dispatch of models/pipeline.py),
as the port's recorder counts them in the pass of synchronised program
spans (program_record.synchronised; the recorder does not count its own
synchronisations); nothing without a card."""

from benchmark import program_record


def read(ctx):
    return program_record.syncs_per_frame(
        program_record.synchronised(ctx), ctx["span_frames"])
