"""decode_roofline: the decode launches' least time (each decoded request's
valid keys and values, query and output at 3.35 TB/s, or its operations at
989 TF/s, whichever is longer, a step) over the decode kernels' device
time in the traced steps, in %."""
from cardbench.core.readings import DECODE_KERNELS, decode_bound_s, \
    roofline_pct


def read(rec):
    return roofline_pct(rec, DECODE_KERNELS,
                        lambda st: decode_bound_s(rec, st))
