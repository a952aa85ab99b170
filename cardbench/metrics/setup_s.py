"""setup_s: seconds from the start of the process to the end of warm-up
(weights made, engine built, kernels loaded or built, every bucket
warmed)."""


def read(rec):
    return rec.setup_s
