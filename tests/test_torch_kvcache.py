"""The port's paged KV cache and paged serving engine against the JAX
package: the engine-level tests of tests/test_kvcache.py and the prefix
hit of tests/test_kv_sharing.py run on both engines with the same weights
(float32, greedy) and must give the same tokens and counters; the pool's
refcounts are conserved under any interleaving; store / load / fork /
export / import_pages move page contents exactly.
"""
import dataclasses
from collections import Counter

import jax  # noqa: F401  (both packages in one process)
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_parity import config_pair, weights_pair
from repro.serving import ServingEngine as JaxEngine
from repro.serving.perllm_server import PerLLMServer as JaxServer
from repro_torch.cluster import paper_testbed
from repro_torch.core import Decision, SchedulingPolicy
from repro_torch.models import init_cache
from repro_torch.serving import ServingEngine
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.perllm_server import PerLLMServer

REDUCED = dict(n_layers=2, d_model=128, vocab_size=512)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = config_pair("gemma-2b", **REDUCED)
    jp, tp = weights_pair(jcfg, tcfg)
    return jcfg, jp, tcfg, tp


def _pair(setup, **kw):
    """The same engine in both packages."""
    jcfg, jp, tcfg, tp = setup
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_seq", 128)
    return (JaxEngine(jcfg, jp, **kw),
            ServingEngine(tcfg, tp, device="cpu", **kw))


def _engine(setup, **kw):
    return _pair(setup, **kw)[1]


# ---------------------------------------------------------------------------
# the paged engine (tests/test_kvcache.py, on both engines)
# ---------------------------------------------------------------------------


def test_paged_engine_matches_dense(setup):
    """With a full-size pool, paging changes bookkeeping only: greedy
    outputs equal the dense engine's and the JAX paged engine's, and every
    block returns to the pool."""
    je, dense = _pair(setup)
    jpaged, paged = _pair(setup, paged=True, kv_block_tokens=16)
    for eng in (dense, paged, jpaged):
        for i in range(7):
            eng.submit(list(range(5, 12 + i)), max_new_tokens=6)
        eng.run_until_idle()
    assert [r.generated for r in paged.completed] \
        == [r.generated for r in dense.completed] \
        == [r.generated for r in jpaged.completed]
    assert paged.kv.free_blocks == paged.kv.n_blocks
    assert paged.n_prefills == 7
    assert paged.stats() == jpaged.stats()


def test_paged_engine_kv_pressure_serializes(setup):
    """A pool holding one request at a time forces admissions to wait for
    free-on-finish — lanes alone no longer set the batch."""
    outs = []
    je, te = _pair(setup, max_batch=4, paged=True, kv_blocks=4,
                   kv_block_tokens=16)
    for eng in (je, te):
        for _ in range(5):
            eng.submit(list(range(4, 20)), max_new_tokens=8)  # 16+8 -> 2 blks
        seen_parallel = 0
        for _ in range(10_000):
            if not eng.queue and not eng.active_slots:
                break
            seen_parallel = max(seen_parallel, eng.step())
        assert len(eng.completed) == 5
        assert seen_parallel <= 2          # 4 lanes idle; blocks bind first
        assert eng.kv.free_blocks == 4
        outs.append([r.generated for r in eng.completed])
    assert outs[1] == outs[0]
    assert te.n_kv_stalls > 0              # the port counts the waits


def test_resumable_request_bypasses_stalled_head(setup):
    """An evicted-resumable request (holding its pages) must pass a queue
    head stalled on allocation — otherwise its held blocks deadlock the
    pool: the head waits on blocks only the resumable request can free."""
    outs = []
    for eng in _pair(setup, max_batch=2, paged=True, kv_blocks=3,
                     kv_block_tokens=16):
        a = eng.submit(list(range(3, 19)), max_new_tokens=8)   # 2 blocks
        for _ in range(3):
            eng.step()
        eng.evict(0)                                           # a holds pages
        b = eng.submit(list(range(4, 20)), max_new_tokens=8)   # needs 2 > 1
        eng.resubmit(a)                                        # behind b
        done = eng.run_until_idle()
        assert {r.rid for r in done} == {a.rid, b.rid}
        assert eng.n_prefills == 2                             # a never re-ran
        assert eng.kv.free_blocks == 3
        outs.append((a.generated, b.generated))
    assert outs[1] == outs[0]


def test_oversized_request_rejected_at_submit(setup):
    for eng in _pair(setup, paged=True, kv_blocks=2, kv_block_tokens=16):
        with pytest.raises(ValueError, match="never be admitted"):
            eng.submit(list(range(40)), max_new_tokens=32)


def test_evict_zeroes_slot_state(setup):
    """Eviction must not leave positions/cur_tokens of the freed lane
    behind for the next admission."""
    eng = _engine(setup, max_batch=1)
    eng.submit(list(range(3, 12)), max_new_tokens=8)
    for _ in range(3):
        eng.step()
    assert eng.positions[0] > 0 and eng.cur_tokens[0] != 0
    req = eng.evict(0)
    assert req is not None and req.slot == -1
    assert eng.positions[0] == 0 and eng.cur_tokens[0] == 0


def test_run_until_idle_surfaces_exhaustion(setup):
    """Exhausting max_steps with work queued raises instead of silently
    dropping requests; a paged engine names its free blocks."""
    eng = _engine(setup, max_batch=1, paged=True, kv_block_tokens=16)
    eng.submit([1, 2, 3], max_new_tokens=6)
    with pytest.raises(RuntimeError, match="remain after .* KV blocks free"):
        eng.run_until_idle(max_steps=2)
    done = eng.run_until_idle()          # a real budget finishes the work
    assert len(done) == 1


def test_evict_resubmit_continuity(setup):
    """A preempted request resumed on the same engine reattaches its page
    table, skips re-prefill and finishes with the uninterrupted run's
    tokens — on both engines."""
    jref, ref = _pair(setup, max_batch=1)
    r_ref = ref.submit(list(range(3, 17)), max_new_tokens=10)
    ref.run_until_idle()
    jr_ref = jref.submit(list(range(3, 17)), max_new_tokens=10)
    jref.run_until_idle()
    assert r_ref.generated == jr_ref.generated

    for eng in _pair(setup, max_batch=1, paged=True, kv_block_tokens=16):
        req = eng.submit(list(range(3, 17)), max_new_tokens=10)
        for _ in range(4):
            eng.step()
        assert 0 < len(req.generated) < 10
        victim = eng.evict(0)
        assert victim is req and req.kv is not None and req.pages is not None
        eng.resubmit(req)
        eng.run_until_idle()
        assert req.done
        assert req.generated == r_ref.generated
        assert eng.n_prefills == 1           # the resume never re-prefilled
        assert eng.kv.free_blocks == eng.kv.n_blocks


def test_evict_without_kv_frees_the_pages(setup):
    """`keep_kv=False` (a memory-pressure eviction) returns the pages at
    once and leaves nothing to resume."""
    eng = _engine(setup, max_batch=1, paged=True, kv_block_tokens=16)
    req = eng.submit(list(range(3, 17)), max_new_tokens=10)
    eng.step()
    assert eng.kv.free_blocks < eng.kv.n_blocks
    eng.evict(0, keep_kv=False)
    assert req.pages is None and req.kv is None
    assert eng.kv.free_blocks == eng.kv.n_blocks


def test_dense_engine_has_no_resubmit(setup):
    eng = _engine(setup, max_batch=1)
    req = eng.submit([1, 2, 3], max_new_tokens=4)
    eng.step()
    eng.evict(0)
    with pytest.raises(AssertionError):
        eng.resubmit(req)


class _PreemptLatest(SchedulingPolicy):
    name = "preempt-latest"

    def __init__(self):
        self.armed = False

    def assign(self, req, view):
        assert view.kv_total_blocks is not None
        victim = None
        if self.armed and view.running and view.running[0]:
            victim = view.running[0][0].sid
        return Decision(server=0, preempt_victim=victim)


def test_live_server_same_server_requeue_skips_prefill(setup):
    """PerLLMServer + paged engine: the preempted victim's requeue lands
    back on its server and resumes from its pages (2 prefills for 2
    requests, not 3), as in the JAX fleet."""
    spec = dataclasses.replace(paper_testbed(n_edge=1)[0],
                               max_concurrency=1, kv_block_tokens=16)
    eng = _engine(setup, max_batch=1, paged=True, kv_block_tokens=16)
    policy = _PreemptLatest()
    srv = PerLLMServer([spec], [eng], scheduler=policy)
    first = srv.submit([1, 2, 3], max_new_tokens=12, payload_bytes=1e4)
    for _ in range(60):
        if srv.engines[0].active_slots:
            break
        srv.step()
    assert srv.engines[0].active_slots
    progressed = len(first.engine_req.generated)
    policy.armed = True
    second = srv.submit([4, 5], max_new_tokens=2, payload_bytes=1e4)
    done = srv.run_until_idle()
    assert srv.n_preempted == 1 and first.service.preemptions == 1
    assert {sr.service.sid for sr in done} \
        == {first.service.sid, second.service.sid}
    assert eng.n_prefills == 2
    # the resumed request kept its pre-eviction progress and finished
    assert len(first.engine_req.generated) == 12 >= progressed > 0
    assert eng.kv.free_blocks == eng.kv.n_blocks


def test_live_server_sheds_pool_oversized_request(setup):
    """PerLLMServer: a routed request bigger than its engine's whole pool
    is shed (rejected outcome) instead of crashing the loop."""
    spec = dataclasses.replace(paper_testbed(n_edge=1)[0],
                               kv_block_tokens=16)
    eng = _engine(setup, max_batch=1, paged=True, kv_blocks=2,
                  kv_block_tokens=16)                      # 32-token pool
    srv = PerLLMServer([spec], [eng])
    ok = srv.submit([1, 2, 3], max_new_tokens=4, payload_bytes=1e4)
    big = srv.submit(list(range(3, 60)), max_new_tokens=8,
                     payload_bytes=1e4)                    # 65 tokens
    done = srv.run_until_idle()
    assert [sr.service.sid for sr in done] == [ok.service.sid]
    assert len(srv.rejected) == 1
    assert srv.rejected[0].service.sid == big.service.sid
    assert eng.kv.free_blocks == 2


# ---------------------------------------------------------------------------
# prefix sharing (tests/test_kv_sharing.py)
# ---------------------------------------------------------------------------


def test_prefix_hit_skips_prefill_bit_exact(setup):
    """A second request opening with a resident 2-block system prompt
    reuses those pages (skipping their prefill), decodes only its suffix
    through the batch-1 decode step, and generates bit-identically to a
    sharing-disabled engine and to the JAX engine's prefix hit."""
    shared = list(range(100, 132))          # 32 tokens = 2 full blocks
    p1 = shared + list(range(7, 15))
    p2 = shared + list(range(200, 208))
    jwarm, warm = _pair(setup, paged=True, kv_block_tokens=16)
    cold = _engine(setup, paged=True, kv_block_tokens=16,
                   prefix_sharing=False)
    for eng in (cold, warm, jwarm):
        eng.submit(list(p1), max_new_tokens=6)
        eng.run_until_idle()
        eng.submit(list(p2), max_new_tokens=6)
        eng.run_until_idle()
    assert [r.generated for r in warm.completed] \
        == [r.generated for r in cold.completed] \
        == [r.generated for r in jwarm.completed]
    assert warm.n_prefix_hits == jwarm.n_prefix_hits == 1
    assert warm.prefix_tokens_reused == 32
    assert cold.n_prefix_hits == 0
    assert warm.kv.free_blocks == warm.kv.n_blocks
    assert (warm.prefill_compiles, warm.decode_compiles) \
        == (jwarm.prefill_compiles, jwarm.decode_compiles)
    assert warm.stats() == jwarm.stats()


def test_golden_disjoint_prompts_unchanged_by_sharing(setup):
    """With no common full block between prompts, the sharing engine takes
    zero hits and generates exactly what a sharing-disabled engine does."""
    on = _engine(setup, paged=True, kv_block_tokens=16)
    off = _engine(setup, paged=True, kv_block_tokens=16,
                  prefix_sharing=False)
    prompts = [list(range(5 + i, 29 + i)) for i in range(4)]  # shifted heads
    for eng in (on, off):
        for p in prompts:
            eng.submit(list(p), max_new_tokens=6)
        eng.run_until_idle()
    assert [r.generated for r in on.completed] \
        == [r.generated for r in off.completed]
    assert on.n_prefix_hits == 0 and off.n_prefix_hits == 0
    assert on.kv.free_blocks == on.kv.n_blocks


def test_supports_prefix_follows_the_leaves():
    """Prefix sharing needs every leaf paged: off for gemma3's rolling
    window layers and for mamba2's SSM states, as in the JAX package."""
    from repro.serving.kvcache import PagedKVCache as JaxPaged
    for arch, want in (("gemma-2b", True), ("gemma3-12b", False),
                       ("mamba2-2.7b", False)):
        jcfg, tcfg = config_pair(arch, **REDUCED)
        t = PagedKVCache(tcfg, 8, 16, 128, device="cpu")
        j = JaxPaged(jcfg, 8, 16, 128)
        assert t.supports_prefix == j.supports_prefix == want, arch
        # JAX stacks a superblock's layers into one leaf, the port keeps
        # one per layer: the same kinds of leaf are paged
        assert {a is None for a in t._seq_axis} \
            == {a is None for a in j._seq_axis}, arch


# ---------------------------------------------------------------------------
# the pool: conservation and round trips
# ---------------------------------------------------------------------------


def _tiny_cache(n_blocks=16, block_tokens=4):
    _, tcfg = config_pair("gemma-2b", **REDUCED)
    return PagedKVCache(tcfg, n_blocks=n_blocks, block_tokens=block_tokens,
                        max_seq=32, device="cpu")


def _assert_conserved(cache, tables):
    """Every block's refcount equals its holder count (live tables plus
    index nodes), and unreferenced blocks are exactly the free pool."""
    held = Counter(b for t in tables for b in t.blocks)
    held += Counter(n.block for n in cache.prefix._nodes())
    for blk in range(cache.n_blocks):
        assert cache.allocator.refcount(blk) == held.get(blk, 0), blk
    assert cache.allocator.free_blocks == cache.n_blocks - len(held)


@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 10 ** 6)),
                max_size=30))
@settings(max_examples=20, deadline=None)
def test_sharing_conservation_under_interleaving(ops):
    """Random interleavings of prefix-shared allocate / register / fork /
    release / export+import / reclaim on the torch pools never leak or
    double-free blocks."""
    cache = _tiny_cache()
    bt = cache.block_tokens
    assert cache.supports_prefix
    pools = [list(range(64 + p * 2 * bt, 64 + (p + 1) * 2 * bt))
             for p in range(3)]
    tables = []
    for code, r in ops:
        if code == 0:                       # admit sharing a pool's prefix
            prompt = pools[r % 3] + [1 + (r // 3) % 400, 1 + (r // 7) % 400]
            t = cache.allocate(len(prompt) + 2, prompt=prompt)
            if t is not None:
                tables.append(t)
                cache.register_prefix(prompt, t)
        elif code == 1 and tables:          # copy-on-write fork
            t2 = cache.fork(tables[r % len(tables)])
            if t2 is not None:
                tables.append(t2)
        elif code == 2 and tables:          # release
            cache.free(tables.pop(r % len(tables)))
        elif code == 3 and tables:          # migrate: export, re-import, swap
            idx = r % len(tables)
            old = tables[idx]
            moved = cache.import_pages(cache.export(old), len(old.blocks))
            if moved is not None:
                tables[idx] = moved
                cache.free(old)
        else:                               # memory pressure on the index
            cache.prefix.reclaim(cache.n_blocks)
        _assert_conserved(cache, tables)
    for t in tables:
        cache.free(t)
    cache.prefix.clear()
    assert cache.allocator.free_blocks == cache.n_blocks


def _filled_slot_cache(cache, seed):
    """A batch-1 dense cache of the pool's model with random contents."""
    gen = torch.Generator().manual_seed(seed)
    one = init_cache(cache.cfg, 1, cache.max_seq, device="cpu")
    for layer in one:
        for leaf in layer.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    return one


def test_store_load_round_trip():
    """`load` gives back what `store` scattered over the table's span, in
    shuffled pages, and zeros past it; the pool view the paged kernel
    reads holds the same rows through the table."""
    cache = _tiny_cache(n_blocks=16, block_tokens=4)
    cache.allocate(8)                       # occupy low ids: shuffled table
    table = cache.allocate(12)              # 3 blocks = 12 tokens
    one = _filled_slot_cache(cache, 0)
    assert cache.store(table, one) == []    # every leaf is paged
    back = cache.load(table, [])
    for layer, got in zip(one, back, strict=True):
        for key in layer:
            assert got[key].shape == layer[key].shape
            torch.testing.assert_close(got[key][:, :12], layer[key][:, :12],
                                       rtol=0, atol=0)
            assert not bool(got[key][:, 12:].any())
    k, v = cache.pool_views(0)
    assert k.shape == (16, 4, 1, 64)
    rows = k[torch.tensor(table.blocks)].reshape(-1, 1, 64)
    torch.testing.assert_close(rows, one[0]["k"][0, :12], rtol=0, atol=0)


def test_store_skips_shared_blocks_and_keeps_state():
    """A table's read-shared head is never written back by `store`; a
    Mamba-2 cache has no paged leaf and its states come back whole."""
    cache = _tiny_cache()
    table = cache.allocate(12)
    first = _filled_slot_cache(cache, 1)
    cache.store(table, first)
    table.shared_blocks = 2                 # as if the head were shared
    second = _filled_slot_cache(cache, 2)
    cache.store(table, second)
    back = cache.load(table, [])
    torch.testing.assert_close(back[0]["k"][:, :8], first[0]["k"][:, :8],
                               rtol=0, atol=0)
    torch.testing.assert_close(back[0]["k"][:, 8:12], second[0]["k"][:, 8:12],
                               rtol=0, atol=0)

    _, tcfg = config_pair("mamba2-2.7b", **REDUCED)
    ssm = PagedKVCache(tcfg, 4, 16, 64, device="cpu")
    t = ssm.allocate(20)
    one = _filled_slot_cache(ssm, 3)
    state = ssm.store(t, one)
    assert len(state) == 2 * tcfg.n_layers
    back = ssm.load(t, state)
    for layer, got in zip(one, back, strict=True):
        for key in layer:
            assert got[key] is layer[key]


def test_fork_export_import_round_trip():
    """A fork shares all but the tail block, whose content is copied; an
    export re-imported elsewhere in the pool holds the same pages."""
    cache = _tiny_cache()
    table = cache.allocate(12)
    one = _filled_slot_cache(cache, 4)
    cache.store(table, one)
    child = cache.fork(table)
    assert child.blocks[:2] == table.blocks[:2] and child.shared_blocks == 2
    assert child.blocks[2] != table.blocks[2]
    for a, b in zip(cache.load(table, []), cache.load(child, []),
                    strict=True):
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    pages = cache.export(table)
    assert all(p.shape == (3, 4, 1, 1, 64) for p in pages)
    moved = cache.import_pages(pages, len(table.blocks))
    assert not set(moved.blocks) & set(table.blocks)
    for a, b in zip(cache.load(table, []), cache.load(moved, []),
                    strict=True):
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not match"):
        cache.store(table, one[:1])
    for t in (table, child, moved):
        cache.free(t)
    assert cache.allocator.free_blocks == cache.n_blocks


# ---------------------------------------------------------------------------
# the paged fleet against the JAX fleet
# ---------------------------------------------------------------------------


def _paged_fleets(kv_blocks=None):
    """tests/test_torch_server.py's fleet, every engine paged."""
    from _torch_parity import numpy_tree
    from repro.cluster import paper_testbed as jax_testbed
    from repro.models import init_params as jax_init_params
    from repro_torch.models.convert import params_from_jax
    key = jax.random.key(0)
    edge = config_pair("gemma-2b", n_layers=2, d_model=64, vocab_size=256)
    cloud = config_pair("gemma3-12b", n_layers=2, d_model=128,
                        vocab_size=256)
    kv = dict(paged=True, kv_blocks=kv_blocks, kv_block_tokens=16)
    js, ts = [], []
    for (jcfg, tcfg), max_batch in ((edge, 2), (edge, 2), (cloud, 4)):
        jp = jax_init_params(key, jcfg)
        tp = params_from_jax(numpy_tree(jp), tcfg, device="cpu")
        js.append(JaxEngine(jcfg, jp, max_batch=max_batch, max_seq=64, **kv))
        ts.append(ServingEngine(tcfg, tp, max_batch=max_batch, max_seq=64,
                                device="cpu", **kv))
    return (JaxServer(jax_testbed(n_edge=2, kv_block_tokens=16), js),
            PerLLMServer(paper_testbed(n_edge=2, kv_block_tokens=16), ts))


@pytest.mark.parametrize("kv_blocks", [None, 6])
def test_paged_fleet_matches_jax_fleet(kv_blocks):
    """The launcher's `--policy perllm --paged [6]` fleet: the same served
    count, per-server counts and tokens as the JAX fleet."""
    js, ts = _paged_fleets(kv_blocks)
    rng = np.random.default_rng(0)
    for _ in range(12):
        p = rng.integers(0, 256, int(rng.integers(4, 16))).tolist()
        js.submit(p, max_new_tokens=4)
        ts.submit(p, max_new_tokens=4)
    jd = {sr.service.sid: sr for sr in js.run_until_idle()}
    td = {sr.service.sid: sr for sr in ts.run_until_idle()}
    assert jd.keys() == td.keys() and len(td) == 12
    for sid, tsr in td.items():
        assert tsr.server == jd[sid].server
        assert tsr.engine_req.generated == jd[sid].engine_req.generated
    assert ts.stats["per_server"] == js.stats["per_server"]
    assert ts.stats["served"] == js.stats["served"] == 12
    assert all(e.kv.free_blocks == e.kv.n_blocks for e in ts.engines)
