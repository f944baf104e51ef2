"""The DT3 build's kernels against their roofline: the least time the card
could take for every build of the window over the device time of the
kernels K2 (envelope and far pass), K3 and K4 in the trace, in %.

The builds come from the scenes of each call in the window, grouped by
canvas bucket as the program builds them: ``S`` scenes of one bucket make
an ``(S, D, side, side)`` stack.  Each kernel's bound is the larger of its
bytes over the HBM rate and its operations over the float32 peak
(NVIDIA's H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s outside the tensor
cores, at 700 W); the arithmetic is ``chip_smoke.work``'s: each input read
once and each output written once (K2 reads the column pass's ``g`` and
writes the distances, K3 and K4 read and write the stack in place), K2
about 24 operations a pixel, K3 an add and a min a step and pixel, K4 one
add a pixel.  K4's small host tables (one delta row a slice) are left out.
K2's far pass has work only for pixels 4,096 px or more from every seed;
a canvas below 4,096 px has none, and on a larger one the far work depends
on the data, so this reader then returns nothing.
"""
import math

from fdcm_bench import reference

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
FAR_PX = 4096
# kernel names in the trace (substrings of the demangled names)
KERNELS = ("edt_rows_kernel", "edt_far_kernel", "prop_fixed", "prop_any",
           "prop_shared", "prop_global", "sweep_paths_kernel")


def builds(run):
    """``(scenes, depth, side)`` of each build of the window."""
    m = run.config["matching"]
    out = []
    for scenes in run.record.calls:
        sides = {}
        for s in scenes:
            _, (w, h) = reference.canvas(s, m["padding"])
            side = -(-max(w, h) // m["pad_to"]) * m["pad_to"]
            sides[side] = sides.get(side, 0) + 1
        out += [(n, m["depth"], side) for side, n in sides.items()]
    return out


def bound_s(n_scenes, depth, side, steps):
    px = n_scenes * depth * side * side
    stack = 4 * px
    k2 = max(2 * stack / HBM_BYTES_PER_S, 24 * px / F32_OPS_PER_S)
    k3 = max(2 * stack / HBM_BYTES_PER_S, 2 * steps * px / depth / F32_OPS_PER_S)
    k4 = max(2 * stack / HBM_BYTES_PER_S, px / F32_OPS_PER_S)
    return k2 + k3 + k4


def read(run):
    if run.trace is None:
        return None
    work = builds(run)
    if not work or max(side for _, _, side in work) >= FAR_PX:
        return None
    m = run.config["matching"]
    steps = len(reference.relaxation_steps(reference.angles_of(m["depth"]), m["dt3_coeff"]))
    spent = run.trace.kernel_s(KERNELS)
    if not spent:
        return None
    least = math.fsum(bound_s(n, d, side, steps) for n, d, side in work)
    return 100.0 * least / spent
