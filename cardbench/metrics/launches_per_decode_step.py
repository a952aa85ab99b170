"""launches_per_decode_step: the host's kernel-launch calls (a graph
launch counts one) inside the traced steps that admitted no prompt, a
step."""


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    pure = [s.idx for s in rec.steps if s.idx in tr.steps and not s.prefills]
    if not pure:
        return None
    return sum(tr.launches.get(i, 0) for i in pure) / len(pure)
