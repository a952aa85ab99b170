"""launches_per_step: the host's kernel-launch calls (a graph launch counts
one) inside the traced steps, a step: the admission's prefills and the
decode step together, for a mix in which every step admits prompts."""


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    traced = [s.idx for s in rec.steps if s.idx in tr.steps]
    if not traced:
        return None
    return sum(tr.launches.get(i, 0) for i in traced) / len(traced)
