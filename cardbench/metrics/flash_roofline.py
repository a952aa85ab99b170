"""flash_roofline: causal attention over each prompt prefilled in the
traced steps, at its own length, at 989 TF/s (or its q, k, v and output at
3.35 TB/s, whichever is longer), over the flash kernel's device time, in
%."""
from cardbench.core.readings import FLASH_KERNELS, flash_bound_s, \
    roofline_pct


def read(rec):
    return roofline_pct(rec, FLASH_KERNELS,
                        lambda st: flash_bound_s(rec, st))
