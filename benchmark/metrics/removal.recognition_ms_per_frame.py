"""removal.recognition_ms_per_frame: ms per frame of the synchronised
program spans "recognition" around recognition.recognize
(models/recognition.py) in the removal windows of the pass of synchronised
spans (program_record.span_ms_per_frame)."""

from benchmark import program_record


def read(ctx):
    return program_record.span_ms_per_frame(ctx, "recognition")
