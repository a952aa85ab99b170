"""Continuous-batching serving engine.

A fixed pool of `max_batch` KV-cache slots; requests are admitted into free
slots (prefill) and all slots decode together each step with per-slot
positions (the `update_cache_seq` vector-position path). This is the
execution layer a PerLLM "server" runs: the scheduler decides *which*
server a request goes to, the engine decides *how* it runs there.

With `paged=True` the engine's KV capacity is a `PagedKVCache` block pool
instead of the implicit `max_batch x max_seq` dense reservation: admission
allocates `ceil((prompt + max_new) / block_tokens)` blocks up front and
stalls (FIFO) when the pool is exhausted. Eviction snapshots the slot's KV
into the request's pages (`evict` -> `Request.kv`), so a preempted request
`resubmit`-ted to the same engine resumes decoding with zero re-prefill;
`release` drops a request's pages when the work moves elsewhere. A prompt
whose head matches resident full blocks attaches them copy-on-write and
decodes only its suffix. The compute view stays the dense per-slot cache,
as in the JAX package: pages are written at evict (and after prefill, for
the prefix index) and read at resume.

On the card, prefill attention runs on the flash kernel, every decode step
of an attention layer on the decode kernel (an MLA layer decodes through
latent matrix products), and a Mamba-2 prefill on the SSD-diagonal kernel;
an RG-LRU layer's recurrence is plain PyTorch. There an unsharded engine
replays each prompt bucket's batch-1 prefill as a CUDA graph
(`prefill_graph_applies`): the reset of a static batch-1 cache, the
prefill, and the copy of that cache into the slot, the same work as the
eager path, issued by one host call. An M-RoPE model (qwen2-vl)
prefills with three equal (3, 1, S) position streams, as the JAX engine
does; recurrent states (Mamba-2, RG-LRU) absorb the bucket padding, as in
the JAX engine.

With ``ctx`` (a `ParallelContext` with a mesh) every rank runs the same
engine over its shards: the weights (`init_params(..., ctx=)`), the slot
cache (cut by `launch.shardings.cache_specs_tree`: its slots over the data
axes, its heads, channels or head_dim, or its sequence for the
context-parallel decode, over the model axis), the slot rows of each decode
step. A prompt prefills on every rank into a batch-1 cache cut as
``cache_specs_tree`` cuts a batch of one (over the model axis alone), whose
rows go into the slot's owners: copied where the slot cache splits a leaf
the same way, gathered and cut again where it does not (a sequence split
for the context-parallel decode). The logits of every slot are gathered, so
every rank samples the same tokens and takes the same admission, allocation
and prefix decisions. A paged engine's pool holds each rank's shard of
every leaf in that batch-1 layout, with whole token blocks; pages move at
prefill, evict, resume, a prefix hit and migration (an evicted slot's row
is gathered from its owner and cut to the pool's layout), never on a decode
step.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import parallel as PAR
from repro_torch.models.parallel import resolve_device
from repro_torch.obs.metrics import MetricsRegistry, counter_attr, with_aliases
from repro_torch.obs.spans import NO_SPAN
from repro_torch.serving.kvcache import KVSnapshot, PagedKVCache, PageTable
from repro_torch.serving.sampling import sample_tokens


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: int = -1          # -1: never stop early
    # runtime
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    # stamps on time.perf_counter: submitted, its prefill (or resume) begun,
    # first token read, finished
    submitted_at: float = 0.0
    admitted_at: float = -1.0
    first_token_at: float = -1.0
    done_at: float = -1.0
    # paged-KV runtime: the request's block-pool pages while it holds any,
    # and the resume snapshot written by `evict` (consumed by re-admission)
    pages: Optional[PageTable] = None
    kv: Optional[KVSnapshot] = None

    @property
    def done(self) -> bool:
        return self.done_at >= 0


def prefill_graph_applies(device, ctx, prefix_hit: bool) -> bool:
    """Whether a prefill replays its bucket's CUDA graph: a bucket prefill
    on a CUDA device with no mesh. A prefix hit's suffix decodes token by
    token from the pool's pages; a sharded engine's prefill runs gloo
    collectives, which no graph captures; the CPU has no graphs."""
    return (torch.device(device).type == "cuda" and not PAR.is_sharded(ctx)
            and not prefix_hit)


@dataclasses.dataclass
class _PrefillGraph:
    graph: torch.cuda.CUDAGraph
    logits: torch.Tensor        # its static (1, V) output
    launches: dict              # the kernel launches its capture recorded


class _GraphInputs:
    """What every bucket's graph reads and writes besides the slot cache:
    one buffer [last, slot, tokens...] (filled by one host-to-device copy a
    prefill), the static batch-1 cache shared by all buckets, and M-RoPE's
    three position streams."""

    def __init__(self, cfg: ModelConfig, max_seq: int, device):
        self.buf = torch.zeros(2 + max_seq, dtype=torch.long, device=device)
        self.cache = M.init_cache(cfg, 1, max_seq, device=device)
        self.leaves = [leaf for layer in self.cache for leaf in layer.values()]
        self.positions = torch.arange(max_seq, device=device).expand(
            3, 1, max_seq) if cfg.mrope else None


class ServingEngine:
    # shape counters kept from the JAX engine, where each new shape is one
    # XLA compile: decode should stay at one (batch, 1) shape, prefill at
    # one per pow-2 prompt bucket (on the card, the prefill graphs captured)
    decode_compiles = counter_attr("engine.decode_compiles")
    prefill_compiles = counter_attr("engine.prefill_compiles")

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 max_seq: int = 1024, device=None, temperature: float = 0.0,
                 seed: int = 0, paged: bool = False,
                 kv_blocks: Optional[int] = None, kv_block_tokens: int = 16,
                 prefix_sharing: bool = True, moe_dispatch: str = "dense",
                 ctx=None):
        if cfg.enc_dec:
            raise ValueError(
                f"{cfg.arch_id} is an encoder-decoder model: the engine's "
                f"prefill batch holds tokens alone, with no audio frames to "
                f"encode (the JAX engine's as well, which fails on "
                f"'audio_frames'); serve it at the model level through "
                f"repro_torch.models.prefill and decode_step")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.ctx = ctx if ctx is not None and ctx.mesh is not None else None
        if self.ctx is not None:
            if cfg.family != "ssm":
                from repro_torch.models.tp import check_kernel_shapes
                check_kernel_shapes(cfg, self.ctx)
            moe_dispatch = ctx.moe_dispatch
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.temperature = temperature
        # the MoE layers' dispatch ("dense" or "capacity"), which the JAX
        # engine takes from its ParallelContext
        MOE.moe_fn(moe_dispatch)        # raises on an unknown name
        self.moe_dispatch = moe_dispatch
        self.cache = M.init_cache(cfg, max_batch, max_seq, device=self.device,
                                  ctx=self.ctx)
        self.positions = [0] * max_batch
        self.cur_tokens = [0] * max_batch
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self._rid = itertools.count()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.completed: List[Request] = []
        self.metrics = MetricsRegistry()
        # the span log (`repro_torch.obs.spans.SpanLog`) of a run that times
        # the engine's phases; None: nothing is recorded
        self.spans = None
        self._compiled_shapes: set = set()
        # the bucket prefills' CUDA graphs (bucket -> _PrefillGraph), their
        # shared memory pool and their _GraphInputs, made at the first
        # graphed prefill
        self._graphs: dict = {}
        self._graph_pool = None
        self._graph_io: Optional[_GraphInputs] = None
        # prefills that captured their bucket's graph, replayed it, or ran
        # eagerly: there from the start, so that a zero reads as one
        for name in ("prefill_graph_captures", "prefill_graph_replays",
                     "prefill_eager"):
            self.metrics.inc(f"engine.{name}", 0)
        self.n_prefills = 0       # prompts actually prefilled (resumes skip)
        # model decode steps run: one a `step` that decodes, one a token of
        # a prefix hit's suffix (not one of the JAX engine's stats keys)
        self.n_decode_steps = 0
        self.n_prefix_hits = 0        # admissions that reused a shared prefix
        self.prefix_tokens_reused = 0  # prompt tokens those hits skipped
        # admissions that found the pool exhausted (the queue head waited,
        # or a resumable continuation passed it); not one of the JAX
        # engine's stats keys
        self.n_kv_stalls = 0
        self.prefix_sharing = bool(prefix_sharing)
        # DVFS pacing hint: the relative clock frequency this engine's host
        # runs at. `step` is frequency-blind; PerLLMServer stretches each
        # tick by 1/freq_scale. Set via `set_freq_scale`.
        self.freq_scale = 1.0
        self.paged = paged
        self.kv: Optional[PagedKVCache] = None
        if paged:
            # default pool: the dense reservation's worth of blocks
            n_blocks = kv_blocks if kv_blocks is not None \
                else max_batch * (max_seq // kv_block_tokens)
            self.kv = PagedKVCache(cfg, n_blocks=n_blocks,
                                   block_tokens=kv_block_tokens,
                                   max_seq=max_seq, device=self.device,
                                   ctx=self.ctx)

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 32,
               eos_id: int = -1) -> Request:
        if self.paged:
            need = self.kv.blocks_for(len(prompt) + max_new_tokens)
            if need > self.kv.n_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool only has "
                    f"{self.kv.n_blocks}; it could never be admitted")
        req = Request(rid=next(self._rid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      submitted_at=time.perf_counter())
        self.queue.append(req)
        return req

    def resubmit(self, req: Request) -> Request:
        """Re-enqueue a previously evicted request on this engine.

        Paged engines only: the request re-enters with its pages and
        `KVSnapshot` attached, so admission reattaches the page table and
        resumes decoding instead of re-running prefill. (Dense engines have
        nothing to reattach — submit the remainder as a new request.)"""
        assert self.paged, "resubmit needs a paged engine (KV survives)"
        assert req.slot < 0 and not req.done, req
        assert req.kv is not None and req.pages is not None, \
            "resubmit is for evicted requests holding a KV snapshot"
        self.queue.append(req)
        return req

    def release(self, req: Request) -> None:
        """Drop an evicted request's pages + snapshot (it is moving to a
        different server, or its work was abandoned)."""
        if self.paged and req.pages is not None:
            self.kv.free(req.pages)
        req.pages = None
        req.kv = None

    def set_freq_scale(self, freq: float) -> None:
        """Set the host's DVFS pacing (relative frequency, nominal 1.0)."""
        if freq <= 0.0:
            raise ValueError(f"freq_scale must be positive, got {freq}")
        self.freq_scale = float(freq)

    @property
    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    @property
    def kv_free_blocks(self) -> Optional[int]:
        """Free KV blocks (None when the engine is dense)."""
        return self.kv.free_blocks if self.paged else None

    @property
    def _sharing(self) -> bool:
        """Prefix sharing live on this engine (paged + enabled + the
        pool's leaf layout supports a prefix index)."""
        return self.paged and self.prefix_sharing \
            and self.kv.supports_prefix

    def _span(self, name: str, **attrs):
        return NO_SPAN if self.spans is None else self.spans.span(name,
                                                                  **attrs)

    def _note_compile(self, kind: str, shape) -> None:
        key = (kind, tuple(shape))
        if key not in self._compiled_shapes:
            self._compiled_shapes.add(key)
            self.metrics.inc(f"engine.{kind}_compiles")

    def _insert_slot(self, slot: int, single_cache) -> None:
        # in place: every leaf of the batch cache takes row `slot` of the
        # single-slot cache (the JAX engine builds a new cache tree)
        with self._span("engine.insert"):
            if self.ctx is not None:
                self._insert_slot_sharded(slot, single_cache)
                return
            for layer, one in zip(self.cache, single_cache, strict=True):
                for key, leaf in layer.items():
                    leaf[slot] = one[key][0]

    def _insert_slot_sharded(self, slot: int, single_cache) -> None:
        """Row `slot` of this rank's cache shards from a batch-1 cache in
        the batch-1 layout (`_one_cache`): each leaf copied where the slot
        cache splits it the same way over the model axis, else gathered
        whole and cut as the slot cache is, into the slot's owners."""
        ctx = self.ctx
        for layer, one, specs, ospecs in zip(
                self.cache, single_cache, self.cache.specs,
                single_cache.specs, strict=True):
            for key, leaf in layer.items():
                spec, t = specs[key], one[key]
                if tuple(spec[1:]) != tuple(ospecs[key][1:]):
                    t = PAR.local_view(PAR.gather_tree(t, ospecs[key], ctx),
                                       (None,) + tuple(spec[1:]), ctx)
                row = slot
                if spec[0] is not None:      # slots split over data axes
                    n = leaf.shape[0]
                    if slot // n != ctx.axis_index(spec[0]):
                        continue
                    row = slot % n
                leaf[row] = t[0]

    def _one_cache(self):
        """An empty batch-1 cache for a prefill: under a mesh cut as
        ``cache_specs_tree`` cuts a batch of one."""
        with self._span("engine.cache"):
            return M.init_cache(self.cfg, 1, self.max_seq,
                                device=self.device, ctx=self.ctx)

    def _extract_slot(self, slot: int):
        """Row `slot` of every cache leaf, as a batch-1 cache of copies
        (under a mesh in the batch-1 layout: the row gathered from its owner
        over the data axes, and cut again where the slot cache splits a
        leaf otherwise)."""
        if self.ctx is None:
            return [{key: leaf[slot:slot + 1].clone()
                     for key, leaf in layer.items()} for layer in self.cache]
        ctx = self.ctx
        out = self._one_cache()
        for layer, dst, specs, ospecs in zip(self.cache, out,
                                             self.cache.specs, out.specs,
                                             strict=True):
            for key, leaf in layer.items():
                spec = specs[key]
                if spec[0] is not None:
                    n = leaf.shape[0]
                    rows = PAR.all_gather(leaf[slot % n:slot % n + 1], ctx,
                                          spec[0], 0)
                    t = rows[slot // n:slot // n + 1]
                else:
                    t = leaf[slot:slot + 1]
                if tuple(spec[1:]) != tuple(ospecs[key][1:]):
                    t = PAR.local_view(
                        PAR.gather_tree(t, (None,) + tuple(spec[1:]), ctx),
                        ospecs[key], ctx)
                dst[key].copy_(t)
        return out

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        with self._span("engine.admit"):
            for slot in range(self.max_batch):
                if self.slot_req[slot] is not None:
                    continue
                if not self.queue:
                    break
                req = self.queue[0]
                if self.paged and req.kv is not None:
                    self.queue.pop(0)
                    self._resume(slot, req)
                    continue
                if self.paged:
                    req.pages = self.kv.allocate(
                        len(req.prompt) + req.max_new_tokens,
                        prompt=req.prompt if self._sharing else None)
                    if req.pages is None:
                        # KV pressure: admission stalls FIFO — but a
                        # resumable continuation further back already holds
                        # its pages (it allocates nothing) and must pass the
                        # stalled head, or its held blocks could deadlock
                        # the pool
                        self.n_kv_stalls += 1
                        ri = next((i for i, q in enumerate(self.queue)
                                   if q.kv is not None), None)
                        if ri is None:
                            break
                        self._resume(slot, self.queue.pop(ri))
                        continue
                self.queue.pop(0)
                self._prefill(slot, req)

    def _prefill(self, slot: int, req: Request) -> None:
        """Prefill `req`'s prompt into `slot` (a prefix hit: decode its
        suffix) and take its first token."""
        req.admitted_at = time.perf_counter()
        plen = len(req.prompt)
        skip = 0
        if self.paged and req.pages is not None \
                and req.pages.shared_blocks > 0:
            skip = req.pages.shared_blocks * self.kv.block_tokens
        # prompts are right-padded to power-of-2 buckets, so the prefill
        # shapes stay at log2(max_seq); attention slots >= plen hold padding
        # K/V that decode overwrites before the position mask reaches them
        # (a recurrent state, Mamba-2's or RG-LRU's, absorbs the padding, as
        # in the JAX engine)
        bucket = 0 if skip else min(1 << max(plen - 1, 1).bit_length(),
                                    self.max_seq)
        graphed = prefill_graph_applies(self.device, self.ctx, skip > 0)
        with self._span("engine.prefill", rid=req.rid, tokens=plen,
                        bucket=bucket):
            if skip > 0:
                # prefix hit: the table's read-shared head already holds
                # the prompt's first `skip` tokens of KV — gather the
                # pages and prefill only the suffix, one token at a time
                # through the batch-1 decode step (`allocate` guarantees
                # skip < plen)
                one_cache = self.kv.load(req.pages, [])
                logits = None
                self._note_compile("decode", (1, 1))
                for i in range(skip, plen):
                    tok = torch.tensor([[req.prompt[i]]], dtype=torch.long,
                                       device=self.device)
                    pos = torch.tensor([i], dtype=torch.int32,
                                       device=self.device)
                    logits, one_cache = M.decode_step(
                        self.params, tok, one_cache, pos, cfg=self.cfg,
                        moe_dispatch=self.moe_dispatch, ctx=self.ctx)
                    self.n_decode_steps += 1
                last_logits = logits
                self.n_prefix_hits += 1
                self.prefix_tokens_reused += skip
            else:
                padded = req.prompt + [0] * (bucket - plen)
                self._note_compile("prefill", (1, bucket))
                self.metrics.inc("engine.prefill_positions", bucket)
                self.metrics.inc("engine.prefill_pad_positions", bucket - plen)
                if graphed:
                    # the graph holds the fresh cache and the slot insert
                    last_logits = self._graph_prefill(slot, padded, plen)
                    one_cache = self._graph_io.cache
                else:
                    prompt = torch.tensor([padded], dtype=torch.long,
                                          device=self.device)
                    one_cache = self._one_cache()
                    batch = {"tokens": prompt}
                    if self.cfg.mrope:
                        batch["positions"] = torch.arange(
                            bucket, device=self.device).expand(3, 1, bucket)
                    last_logits, one_cache = M.prefill(
                        self.params, batch, one_cache, cfg=self.cfg,
                        last=plen - 1, moe_dispatch=self.moe_dispatch,
                        ctx=self.ctx)
            if not graphed:
                self.metrics.inc("engine.prefill_eager")
            self.n_prefills += 1
            if self._sharing:
                # publish the prompt's full blocks while they really hold
                # its KV (pages are otherwise only written at eviction) so
                # later admissions can attach them copy-on-write
                self.kv.store_prefix(req.pages, one_cache, n_tokens=plen)
                self.kv.register_prefix(req.prompt, req.pages)
            with self._span("engine.sync"):
                tok = int(sample_tokens(last_logits, self.temperature,
                                        generator=self._gen)[0])
            if not graphed:
                self._insert_slot(slot, one_cache)
            req.first_token_at = time.perf_counter()
        req.slot = slot
        req.generated.append(tok)
        self.positions[slot] = plen
        self.cur_tokens[slot] = tok
        self.slot_req[slot] = req
        self._maybe_finish(slot)

    def _graph_prefill(self, slot: int, padded: List[int], plen: int):
        """The bucket prefill of `padded` (a prompt of `plen` tokens and its
        padding) into `slot` on the graph path: the static inputs filled,
        then the bucket's graph replayed. A bucket's first prefill runs the
        graph's work once eagerly, which gives this prompt's logits and
        makes every lazy initialisation before the capture, then captures
        it. Returns the (1, V) logits."""
        bucket = len(padded)
        if self._graph_io is None:
            self._graph_io = _GraphInputs(self.cfg, self.max_seq, self.device)
        host = torch.tensor([plen - 1, slot] + padded, dtype=torch.long,
                            pin_memory=self.device.type == "cuda")
        self._graph_io.buf[:2 + bucket].copy_(host, non_blocking=True)
        g = self._graphs.get(bucket)
        if g is not None:
            with torch.cuda.device(self.device):
                g.graph.replay()
            kops.add_launches(g.launches)
            self.metrics.inc("engine.prefill_graph_replays")
            return g.logits
        logits = self._graph_body(bucket)
        self._capture(bucket)
        self.metrics.inc("engine.prefill_graph_captures")
        return logits

    def _graph_body(self, bucket: int):
        """The work of bucket `bucket`'s graph: the static batch-1 cache
        zeroed (the fresh cache `_one_cache` gives the eager path), the
        buffer's tokens prefilled into it with the head on row `last`, and
        every leaf copied into row `slot` of the slot cache. Returns the
        (1, V) logits."""
        io = self._graph_io
        torch._foreach_zero_(io.leaves)
        batch = {"tokens": io.buf[2:2 + bucket][None]}
        if self.cfg.mrope:
            batch["positions"] = io.positions[..., :bucket]
        logits, one = M.prefill(self.params, batch, io.cache, cfg=self.cfg,
                                last=io.buf[0:1],
                                moe_dispatch=self.moe_dispatch)
        slot = io.buf[1:2]
        for layer, src in zip(self.cache, one, strict=True):
            for key, leaf in layer.items():
                leaf.index_copy_(0, slot, src[key])
        return logits

    def _capture(self, bucket: int) -> None:
        """Capture `_graph_body(bucket)` as a CUDA graph, in the memory
        pool every bucket's graph shares (one prefill runs at a time, and
        its logits are read before the next). The capture launches
        nothing: the launch counters give back its wrapper calls, and each
        replay adds them."""
        with torch.cuda.device(self.device):
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            before = kops.kernel_launches()
            with torch.cuda.graph(graph, pool=self._graph_pool):
                logits = self._graph_body(bucket)
        recorded = {k: v - before[k]
                    for k, v in kops.kernel_launches().items()}
        kops.add_launches({k: -v for k, v in recorded.items()})
        self._graphs[bucket] = _PrefillGraph(graph, logits, recorded)

    def _resume(self, slot: int, req: Request) -> None:
        """Reattach an evicted request: gather its pages back into the
        slot's dense compute cache and continue decoding — no prefill."""
        req.admitted_at = time.perf_counter()
        snap = req.kv
        req.kv = None
        self._insert_slot(slot, self.kv.load(req.pages, snap.state))
        req.slot = slot
        self.positions[slot] = snap.position
        self.cur_tokens[slot] = snap.cur_token
        self.slot_req[slot] = req
        self._maybe_finish(slot)

    def evict(self, slot: int, keep_kv: bool = True) -> Optional[Request]:
        """Preempt the request occupying `slot`, returning its lane.

        The request is detached un-finished with its partial generation
        kept on the object. A paged engine snapshots the slot's KV into
        the request's pages first (`Request.kv`), so `resubmit` here skips
        re-prefill — unless `keep_kv=False` (a memory-pressure eviction:
        the pages go straight back to the pool, no snapshot scatter). A
        dense engine drops the KV either way (the next admission
        overwrites the rows). The freed lane's `positions`/`cur_tokens`
        are zeroed. The caller decides whether the remaining tokens run
        here or elsewhere (and must `release` the pages if elsewhere)."""
        req = self.slot_req[slot]
        if req is None:
            return None
        if self.paged and not keep_kv:
            self.release(req)
        elif self.paged:
            state = self.kv.store(req.pages, self._extract_slot(slot))
            req.kv = KVSnapshot(state=state,
                                position=int(self.positions[slot]),
                                cur_token=int(self.cur_tokens[slot]))
        self.slot_req[slot] = None
        self.positions[slot] = 0
        self.cur_tokens[slot] = 0
        req.slot = -1
        return req

    def _maybe_finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is None:
            return
        last = req.generated[-1]
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id >= 0 and last == req.eos_id)
                or self.positions[slot] >= self.max_seq - 1):
            req.done_at = time.perf_counter()
            self.completed.append(req)
            self.slot_req[slot] = None
            self.positions[slot] = 0
            self.cur_tokens[slot] = 0
            self.release(req)      # free-on-finish: pages return to the pool

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Admit + one decode step for all slots. Returns #active."""
        if self.spans is None:
            return self._step()
        with self.spans.span("engine.step") as s, self.spans.model_ranges():
            n = self._step()
            s.attrs["active"] = n
        return n

    def _step(self) -> int:
        self._admit()
        active = self.active_slots
        if not active:
            return 0
        tokens = torch.tensor(self.cur_tokens, dtype=torch.long,
                              device=self.device)[:, None]
        pos = torch.tensor(self.positions, dtype=torch.int32,
                           device=self.device)
        self._note_compile("decode", tokens.shape)
        with self._span("engine.decode"):
            logits, self.cache = M.decode_step(
                self.params, tokens, self.cache, pos, cfg=self.cfg,
                moe_dispatch=self.moe_dispatch, ctx=self.ctx)
        self.n_decode_steps += 1
        with self._span("engine.sync"):
            next_tokens = sample_tokens(logits, self.temperature,
                                        generator=self._gen).tolist()
        for slot in active:
            req = self.slot_req[slot]
            req.generated.append(next_tokens[slot])
            self.positions[slot] += 1
            self.cur_tokens[slot] = next_tokens[slot]
            self._maybe_finish(slot)
        return len(active)

    def stats(self) -> dict:
        """Engine-local counters under the canonical key namespace shared
        with ``PerLLMServer.stats`` (old spellings ride along as deprecated
        aliases)."""
        out = {
            "n_prefills": self.n_prefills,
            "n_prefix_hits": self.n_prefix_hits,
            "kv_prefill_tokens_saved": self.prefix_tokens_reused,
            "n_queued": len(self.queue),
            "n_active": len(self.active_slots),
            "n_served": len(self.completed),
        }
        if self.paged:
            out["kv_free_blocks"] = self.kv.free_blocks
            out["kv_total_blocks"] = self.kv.n_blocks
        return with_aliases(out)

    def run_until_idle(self, max_steps: int = 10_000) -> List[Request]:
        """Step until queue and slots drain. Raises if `max_steps` runs out
        with work still pending (with paged KV a stall can also mean the
        queue head needs blocks held by evicted-but-never-released
        snapshots)."""
        for _ in range(max_steps):
            if not self.queue and not self.active_slots:
                return self.completed
            self.step()
        if self.queue or self.active_slots:
            raise RuntimeError(
                f"run_until_idle: {len(self.queue)} queued and "
                f"{len(self.active_slots)} active requests remain after "
                f"{max_steps} steps"
                + (f" ({self.kv.free_blocks}/{self.kv.n_blocks} KV blocks "
                   f"free)" if self.paged else ""))
        return self.completed
