"""removal.segment_kernel_share_pct: the share of the port's segment sums
in a removal pool pass that ran the hand-written kernel of
csrc/segment_sum.cu, 100 x card / (card + plain), from the named counts
`segment_sum.card` and `segment_sum.plain` of the port's recorder in the
pass of synchronised program spans (program_record.synchronised). None
off a card, where there is no kernel to take, and where the recorder keeps
no such counts (a port without the kernel)."""

from benchmark import program_record


def read(ctx):
    rec = program_record.synchronised(ctx)
    if not getattr(rec, "cuda", False) or not getattr(rec, "counts", None):
        return None
    card = rec.counts.get("segment_sum.card", 0)
    plain = rec.counts.get("segment_sum.plain", 0)
    if card + plain == 0:
        return None
    return 100.0 * card / (card + plain)
