"""The port's dry run on the production meshes, in this process.

`run_one` on the 256-rank (16, 16) mesh for gemma-2b ``decode_32k``
(context-parallel decode: one kv-head on a model axis of 16),
``prefill_32k`` and ``train_4k`` and deepseek-moe-16b ``train_4k`` (the
ZeRO-1 train step), and on the 512-rank mesh for gemma-2b ``decode_32k``:
a fake process group, meta tensors, each report's fields, a rank's
parameter bytes equal to the sum of its local shards, and no full-size
allocation (the process's peak resident memory grows by less than 1 GiB,
where one rank's shards alone are hundreds of MB and its step's
temporaries tens of GB). gemma-2b's vocabulary of 256000 splits over the
model axis: its prefill runs the head on the last row and its loss is the
vocabulary-parallel cross-entropy, so neither gathers float32 logits over
every position (which took 129 and 46 GiB a rank, and 68 and 141 GiB of
all-gathers).
"""
import math
import resource

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import model as M
from repro_torch.models import parallel as PAR
from repro_torch.training.optimizer import leaves

FIELDS = {"arch", "shape", "mesh", "n_devices", "param_bytes",
          "opt_state_bytes", "batch_bytes", "cache_bytes",
          "argument_size_in_bytes", "temp_peak_bytes", "collective_bytes",
          "collective_calls", "global_flops", "global_bytes_unfused"}


@pytest.fixture(scope="module")
def reports():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    try:
        out = {
            ("gemma-2b", "decode_32k", False): dryrun.run_one(
                "gemma-2b", "decode_32k", verbose=False),
            ("deepseek-moe-16b", "train_4k", False): dryrun.run_one(
                "deepseek-moe-16b", "train_4k", verbose=False),
            ("gemma-2b", "decode_32k", True): dryrun.run_one(
                "gemma-2b", "decode_32k", multi_pod=True, verbose=False),
            ("gemma-2b", "prefill_32k", False): dryrun.run_one(
                "gemma-2b", "prefill_32k", verbose=False),
            ("gemma-2b", "train_4k", False): dryrun.run_one(
                "gemma-2b", "train_4k", verbose=False),
        }
    finally:
        dryrun.close()
    grown_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    return out, grown_kib


def _local_param_bytes(arch, shape, names):
    cfg = get_config(arch)
    ctx = PAR.ParallelContext(
        mesh=PAR.Mesh.abstract(shape, names),
        batch_axes=("pod", "data") if "pod" in names else ("data",))
    shapes = M.params_shapes(cfg)
    sizes = PAR.map_trees(
        lambda t, s: math.prod(PAR.local_shape(t.shape, s, ctx))
        * t.element_size(), shapes, PAR.param_specs(shapes, ctx))
    return sum(leaves(sizes))


@pytest.mark.parametrize("key", [("gemma-2b", "decode_32k", False),
                                 ("deepseek-moe-16b", "train_4k", False),
                                 ("gemma-2b", "decode_32k", True),
                                 ("gemma-2b", "prefill_32k", False),
                                 ("gemma-2b", "train_4k", False)])
def test_report_fields_and_parameter_bytes(reports, key):
    rep = reports[0][key]
    assert FIELDS <= set(rep), FIELDS - set(rep)
    arch, _, multi_pod = key
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    assert rep["mesh"] == list(shape)
    assert rep["n_devices"] == math.prod(shape)
    assert rep["param_bytes"] == _local_param_bytes(arch, shape, names)
    assert rep["argument_size_in_bytes"] == sum(
        rep[k] for k in ("param_bytes", "opt_state_bytes", "batch_bytes",
                         "cache_bytes"))
    assert rep["temp_peak_bytes"] > 0 and rep["global_flops"] > 0
    coll = rep["collective_bytes"]
    assert coll["total"] == sum(coll[k] for k in dryrun.COLLECTIVES)


def test_decode_is_context_parallel_and_train_is_zero1(reports):
    reps = reports[0]
    dec = reps[("gemma-2b", "decode_32k", False)]
    assert dec["cache_bytes"] > 0 and dec["opt_state_bytes"] == 0
    assert dec["collective_calls"]["all-reduce"] > 0     # the CP combine
    tr = reps[("deepseek-moe-16b", "train_4k", False)]
    assert tr["opt_state_bytes"] > 0 and tr["cache_bytes"] == 0
    assert tr["collective_calls"]["reduce-scatter"] > 0  # ZeRO gradients
    # the 512-rank mesh halves a rank's cache rows of the 256-rank one
    assert reps[("gemma-2b", "decode_32k", True)]["cache_bytes"] * 2 \
        == dec["cache_bytes"]


def test_nothing_full_size_is_allocated(reports):
    reps, grown_kib = reports
    assert grown_kib < 1024 * 1024
    assert max(r["temp_peak_bytes"] for r in reps.values()) > 2 ** 30


GIB = 2 ** 30


@pytest.mark.parametrize("shape,peak_gib,gather_gib", [
    ("prefill_32k", 4, 8), ("train_4k", 12, 20)])
def test_head_gathers_no_logits_over_every_position(reports, shape,
                                                    peak_gib, gather_gib):
    """A rank's peak and all-gather bytes, far below those of a head that
    gathers (B, S, V) float32 logits (prefill 129 GiB and 68 GiB, train
    46 GiB and 141 GiB) and above the sound ones (about 2.7 and 5.7, 9.9
    and 16)."""
    rep = reports[0][("gemma-2b", shape, False)]
    assert rep["temp_peak_bytes"] < peak_gib * GIB
    assert rep["collective_bytes"]["all-gather"] < gather_gib * GIB
