"""Percent of its roofline that the SSD scan reaches in the profiled
slice: the least time of its calls (each chunk of each dispatched step,
once a layer, its padded width rounded up to whole scan chunks;
``work.ssd_chunk`` at the float32 (3xTF32) peak) over the device time of
``ssd_cb``, ``ssd_chunk`` and ``ssd_state``."""
from arrow_bench import peaks, readers, work

KERNELS = ("ssd_cb", "ssd_chunk", "ssd_state")


def read(run):
    H, P, N, G, Q = run.family.scan_shape(run.conf)
    L = run.family.n_layers(run.conf)

    def bound(d):
        return L * sum(work.bound_s(*work.ssd_chunk(-(-w // Q) * Q, H, P, N,
                                                    G, Q),
                                    peaks.TF32X3_FLOPS)
                       for _, _, w, _ in d.chunks)

    return readers.kernel_roofline(run, KERNELS, bound)
