"""Percent of its roofline that the paged decode kernel reaches in the
profiled slice: the least time of its calls (each dispatched decode step,
once a layer, over every slot of the instance: a decoding row at its
context length from the harness's records, any other row at length 1;
``work.paged_decode`` at the bf16 peak) over the device time of
``paged_decode_split`` and ``paged_merge``."""
from arrow_bench import peaks, readers, work

KERNELS = ("paged_decode_split", "paged_merge")


def read(run):
    H, Hk, D = run.family.attn_shape(run.conf)
    L = run.family.n_layers(run.conf)

    def bound(d):
        if not d.decode_ctx:
            return 0.0
        lengths = d.decode_ctx + [1] * (d.n_slots - len(d.decode_ctx))
        return L * work.bound_s(*work.paged_decode(lengths, H, Hk, D,
                                                   d.capacity),
                                peaks.BF16_FLOPS)

    return readers.kernel_roofline(run, KERNELS, bound)
