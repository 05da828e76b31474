"""The int8 product kernel's (``ops/quant.py::qmm`` -> ``csrc/qmm.cu``)
share of its roofline: the least time of the profiled batch's recurrence
products (4 a decoder step at the batch's size, ``counts.qmm``) over the
device time of the kernels named ``qmm_kernel`` in the profiler slice, in
percent. Nothing to read where the kernel did not run."""

from perfbench.counts.qmm import decoder_step_products, qmm_bound_s


def read(run):
    t = sum(s for n, s in run.profile["kernels"].items()
            if "qmm_kernel" in n)
    if t <= 0 or not run.profiled:
        return None
    bound, _ = qmm_bound_s(decoder_step_products(run.cfg["model"],
                                                 run.profiled["batch"]))
    return 100.0 * run.profiled["steps"] * bound / t
