"""Percent of its roofline that the chunked-prefill attention kernel
reaches in the profiled slice: the least time of its calls (each chunk of
each dispatched step, once a layer, at its padded width and offset;
``work.flash_chunk`` at the bf16 peak) over the device time of
``flash_fwd_wgmma`` and ``flash_fwd_merge``."""
from arrow_bench import peaks, readers, work

KERNELS = ("flash_fwd_wgmma", "flash_fwd_merge")


def read(run):
    H, Hk, D = run.family.attn_shape(run.conf)
    L = run.family.n_layers(run.conf)

    def bound(d):
        return L * sum(work.bound_s(*work.flash_chunk(w, off, H, Hk, D),
                                    peaks.BF16_FLOPS)
                       for off, _, w, _ in d.chunks)

    return readers.kernel_roofline(run, KERNELS, bound)
