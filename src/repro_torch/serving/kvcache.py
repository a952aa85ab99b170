"""Paged KV cache: a fixed block pool, per-request page tables, snapshots.

The dense engine pre-books one `(max_seq, ...)` cache lane per batch slot,
so a server's KV capacity is `max_batch` whatever the requests' lengths,
and evicting a request throws its prefill away. This module makes KV
memory a countable resource:

* `BlockAllocator`, `PrefixIndex`, `PageTable`, `KVSnapshot` and
  `blocks_needed` are the JAX package's pure-Python bookkeeping, copied
  verbatim (`tests/test_torch_copies.py` fails when they drift): a
  reference-counted free list, a radix tree of full prompt blocks for
  prefix sharing, one request's block ids, and an evicted request's
  resume state.
* `PagedKVCache` is the storage side, on torch pools: for every cache leaf
  with a sequence axis it keeps a `(n_blocks, block_tokens, ...)` pool on
  the engine's device and can scatter a slot's dense cache into a
  request's pages (`store`, at eviction) and gather it back (`load`, at
  resume), so a preempted request re-enters without re-running prefill.
  Leaves with no sequence axis (Mamba-2 SSM and conv states, rolling
  windows smaller than `max_seq`) are snapshot whole in the returned state
  list.

Layout: the port's cache is a list of one dict per layer, batch-first, so
an attention leaf `(1, S, Hkv, D)` becomes a pool `(n_blocks,
block_tokens, 1, Hkv, D)`, and `pool[:, :, 0]` is the `(n_pool, page, Hkv,
D)` view that `repro_torch.kernels.ops.paged_attention` reads through a
page table. The engine's compute view stays the dense per-slot cache, as
in the JAX package.

Under a mesh (``ctx``) each rank's pool holds its shard of every leaf as
``launch.shardings.cache_specs_tree`` cuts a batch of one: heads, head_dim
or channels over the model axis, whole token blocks (a batch of one never
splits its sequence). The block ids, the allocator and the prefix index are
the same on every rank, since every rank runs the same host code on the
same prompts. `store` takes a slot cache in that layout, and `load` gives
it back so (a `ShardedCache`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import parallel as PAR
from repro_torch.models.parallel import resolve_device


class BlockAllocator:
    """Reference-counted free-list allocator over a fixed pool of KV
    blocks. `allocate` hands out blocks at refcount 1; `ref` adds a
    holder (a sharing page table or the prefix index); `free` drops one
    holder and only returns the block to the pool when nobody holds it."""

    def __init__(self, n_blocks: int):
        if n_blocks <= 0:
            raise ValueError(f"need a positive block pool, got {n_blocks}")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._ref = [0] * n_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def allocate(self, n: int) -> Optional[List[int]]:
        """`n` block ids, or None if the pool can't satisfy the request
        (callers treat that as admission back-pressure, not an error)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
        return ids

    def ref(self, ids: List[int]) -> None:
        """Add a holder to already-live blocks (prefix sharing / COW)."""
        for i in ids:
            if self._ref[i] <= 0:
                raise ValueError(f"ref of free KV block {i}")
            self._ref[i] += 1

    def free(self, ids: List[int]) -> None:
        for i in ids:
            if self._ref[i] <= 0:
                raise ValueError(f"double free of KV block {i}")
            self._ref[i] -= 1
            if self._ref[i] == 0:
                self._free.append(i)


class _PrefixNode:
    """One full block of a registered prompt: `key` is the block's token
    content, `block` the physical block id the index holds a ref on."""

    __slots__ = ("key", "block", "children", "parent", "stamp")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children = {}
        self.stamp = 0


class PrefixIndex:
    """Radix tree over full KV blocks, keyed by token content.

    Each node owns one allocator reference on its block, so indexed
    prefixes survive the registering request's release — that is what
    turns a finished request's prefill into reusable capacity. `match`
    walks the longest indexed chain of full blocks that is a strict
    prefix of `tokens` (at least one suffix token always remains, so a
    hit still produces next-token logits). Under pool pressure `reclaim`
    evicts least-recently-touched leaves; evicting a leaf whose block is
    still held by a live table merely drops the index's share."""

    def __init__(self, allocator: BlockAllocator, block_tokens: int):
        self.allocator = allocator
        self.block_tokens = block_tokens
        self._root = _PrefixNode(key=None, block=-1, parent=None)
        self._clock = 0
        self.n_nodes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _nodes(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    @property
    def reclaimable_blocks(self) -> int:
        """Blocks the index could return to the pool right now: indexed
        blocks no live table shares (refcount 1 — the index's own)."""
        return sum(1 for n in self._nodes()
                   if self.allocator.refcount(n.block) == 1)

    def match(self, tokens: List[int]) -> List[int]:
        """Block ids of the longest indexed full-block strict prefix of
        `tokens`, freshening their LRU stamps."""
        bt = self.block_tokens
        limit = max(0, (len(tokens) - 1) // bt)
        blocks: List[int] = []
        node = self._root
        stamp = self._tick()
        for k in range(limit):
            child = node.children.get(tuple(tokens[k * bt:(k + 1) * bt]))
            if child is None:
                break
            child.stamp = stamp
            blocks.append(child.block)
            node = child
        return blocks

    def register(self, tokens: List[int], blocks: List[int]) -> None:
        """Index the full blocks of a just-prefilled prompt. Existing
        nodes win (content-addressed: same tokens, interchangeable
        blocks); each newly inserted node takes one allocator ref."""
        bt = self.block_tokens
        node = self._root
        stamp = self._tick()
        for k in range(min(len(tokens) // bt, len(blocks))):
            key = tuple(tokens[k * bt:(k + 1) * bt])
            child = node.children.get(key)
            if child is None:
                child = _PrefixNode(key, blocks[k], node)
                self.allocator.ref([blocks[k]])
                node.children[key] = child
                self.n_nodes += 1
            child.stamp = stamp
            node = child

    def _evict(self, node: _PrefixNode) -> None:
        del node.parent.children[node.key]
        self.n_nodes -= 1
        self.allocator.free([node.block])

    def reclaim(self, n_free_target: int) -> bool:
        """Evict LRU leaves until the allocator has `n_free_target` free
        blocks (or no useful eviction remains). Returns success."""
        while self.allocator.free_blocks < n_free_target:
            leaves = [n for n in self._nodes() if not n.children]
            if not leaves:
                return False
            owned = [n for n in leaves
                     if self.allocator.refcount(n.block) == 1]
            if not owned and self.reclaimable_blocks == 0:
                # every remaining indexed block is shared with a live
                # table: evicting gains nothing now or transitively
                return False
            pool = owned or leaves
            self._evict(min(pool, key=lambda n: n.stamp))
        return True

    def clear(self) -> None:
        def drop(node):
            for child in list(node.children.values()):
                drop(child)
            self._evict(node)
        for child in list(self._root.children.values()):
            drop(child)


@dataclasses.dataclass
class PageTable:
    """One request's pages: physical block ids in logical order.

    The first `shared_blocks` blocks are copy-on-write prefix pages,
    read-shared with the prefix index (and possibly other tables): their
    content is immutable, `store` never writes them back."""

    blocks: List[int]
    block_tokens: int
    shared_blocks: int = 0

    @property
    def capacity_tokens(self) -> int:
        return len(self.blocks) * self.block_tokens

    def padded(self, n_pages: int) -> List[int]:
        """Block-table row for the paged kernel: padded with page 0 (the
        kernel masks padded pages via valid_len)."""
        assert n_pages >= len(self.blocks), (n_pages, len(self.blocks))
        return self.blocks + [0] * (n_pages - len(self.blocks))


@dataclasses.dataclass
class KVSnapshot:
    """What an evicted request keeps besides its pages: the unpaged state
    leaves and the decode cursor, enough to resume without re-prefill."""

    state: List[Any]          # non-sequence cache leaves, flat order
    position: int             # next cache write position
    cur_token: int            # last sampled token (next decode input)


def blocks_needed(n_tokens: int, block_tokens: int) -> int:
    """Blocks covering `n_tokens` of KV (minimum one — even an empty
    request owns its first page)."""
    return max(1, math.ceil(n_tokens / block_tokens))



class PagedKVCache:
    """Block-pool storage for one engine's KV cache."""

    def __init__(self, cfg: ModelConfig, n_blocks: int, block_tokens: int,
                 max_seq: int, dtype=None, device=None, ctx=None):
        if max_seq % block_tokens:
            raise ValueError(
                f"block_tokens={block_tokens} must divide max_seq={max_seq}")
        self.cfg = cfg
        self.block_tokens = block_tokens
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.allocator = BlockAllocator(n_blocks)
        # Probe which leaves carry the sequence axis: leaves whose shape
        # changes with max_seq are paged; the rest (recurrent states, conv
        # buffers, rolling windows < max_seq) are snapshot-wholesale state.
        # The meta device gives the shapes without allocating.
        shape_a = M.init_cache(cfg, 1, max_seq, dtype=dtype, device="meta")
        shape_b = M.init_cache(cfg, 1, max_seq // 2, dtype=dtype,
                               device="meta")
        flat_a, self._structure = _flatten_cache(shape_a)
        flat_b, _ = _flatten_cache(shape_b)
        self.ctx = ctx if PAR.is_sharded(ctx) else None
        if self.ctx is not None:
            from repro_torch.launch.shardings import cache_specs_tree
            self._spec_tree = cache_specs_tree(cfg, self.ctx, 1, max_seq)
            specs, _ = _flatten_cache(self._spec_tree)
        self._seq_axis: List[Optional[int]] = []
        self._pools: List[Optional[torch.Tensor]] = []
        for n, (a, b) in enumerate(zip(flat_a, flat_b, strict=True)):
            axis = next((i for i, (x, y)
                         in enumerate(zip(a.shape, b.shape, strict=True))
                         if x != y), None)
            if axis is not None and a.shape[axis] != max_seq:
                axis = None       # seq-dependent but not max_seq-sized
            self._seq_axis.append(axis)
            if axis is None:
                self._pools.append(None)
                continue
            shape = tuple(a.shape) if self.ctx is None \
                else PAR.local_shape(a.shape, specs[n], self.ctx)
            rest = shape[:axis] + shape[axis + 1:]
            self._pools.append(torch.zeros(
                (n_blocks, block_tokens) + tuple(rest), dtype=a.dtype,
                device=self.device))
        # prefix sharing needs the pages to BE the whole per-request
        # state: any non-sequence leaf (SSM states, rolling windows)
        # carries history the pages can't reproduce for a different
        # request, so such models keep the index off
        self.supports_prefix = bool(self._seq_axis) \
            and all(a is not None for a in self._seq_axis)
        self.prefix: Optional[PrefixIndex] = \
            PrefixIndex(self.allocator, block_tokens) \
            if self.supports_prefix else None

    # ------------------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return self.allocator.n_blocks

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: truly free plus what the prefix index
        would surrender under pressure (indexed blocks no table shares).
        This is the number admission control may count on."""
        free = self.allocator.free_blocks
        if self.prefix is not None:
            free += self.prefix.reclaimable_blocks
        return free

    def pool_views(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer `layer`'s K and V pools as (n_pool, page, Hkv, D) views,
        the model layout `ops.paged_attention` takes."""
        names = self._leaf_names()
        views = []
        for key in ("k", "v"):
            pool = self._pools[names.index((layer, key))] \
                if (layer, key) in names else None
            if pool is None:
                raise ValueError(f"layer {layer} has no paged {key} cache")
            views.append(pool[:, :, 0])
        return views[0], views[1]

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_needed(min(n_tokens, self.max_seq), self.block_tokens)

    def _allocate_fresh(self, n: int) -> Optional[List[int]]:
        ids = self.allocator.allocate(n)
        if ids is None and self.prefix is not None \
                and self.prefix.reclaim(n):
            ids = self.allocator.allocate(n)
        return ids

    def allocate(self, n_tokens: int,
                 prompt: Optional[List[int]] = None) -> Optional[PageTable]:
        """A page table covering `n_tokens`. With `prompt` given and a
        prefix index live, resident full blocks matching the prompt's
        head are attached read-shared (`shared_blocks`) instead of being
        allocated — the caller skips that much prefill."""
        shared: List[int] = []
        if prompt is not None and self.prefix is not None:
            shared = self.match_prefix(prompt)
        if shared:
            # pin before allocating: the pressure reclaim below must not
            # evict-and-recycle the very blocks we are about to share
            self.allocator.ref(shared)
        ids = self._allocate_fresh(self.blocks_for(n_tokens) - len(shared))
        if ids is None:
            if shared:
                self.allocator.free(shared)
            return None
        return PageTable(blocks=shared + ids,
                         block_tokens=self.block_tokens,
                         shared_blocks=len(shared))

    def match_prefix(self, prompt: List[int]) -> List[int]:
        """Resident full-block ids covering `prompt`'s head ([] without
        an index). Always a strict prefix: >= 1 suffix token remains."""
        if self.prefix is None:
            return []
        return self.prefix.match(prompt)

    def fork(self, table: PageTable) -> Optional[PageTable]:
        """Copy-on-write duplicate of a live table: all but the last
        block are reference-shared; the last (still-written) block is
        copied into a fresh one. None under pool exhaustion."""
        shared = table.blocks[:-1]
        if shared:
            self.allocator.ref(shared)
        tail = self._allocate_fresh(1)
        if tail is None:
            if shared:
                self.allocator.free(shared)
            return None
        src = table.blocks[-1]
        for pool in self._pools:
            if pool is not None:
                pool[tail[0]] = pool[src]
        return PageTable(blocks=shared + tail,
                         block_tokens=self.block_tokens,
                         shared_blocks=len(shared))

    def free(self, table: PageTable) -> None:
        self.allocator.free(table.blocks)
        table.blocks = []
        table.shared_blocks = 0

    # ------------------------------------------------------------------
    def store(self, table: PageTable, slot_cache) -> List[Any]:
        """Scatter a dense single-slot cache into `table`'s pages.

        Only the table's `capacity_tokens` prefix of each sequence leaf is
        persisted (the request can never have written beyond it), and the
        table's leading `shared_blocks` copy-on-write pages are skipped —
        they are read-shared and already hold exactly this content.
        Returns the non-sequence state leaves for the caller's
        `KVSnapshot` (the caller hands over tensors it no longer writes)."""
        flat = self._flatten(slot_cache)
        skip = table.shared_blocks
        write = table.blocks[skip:]
        ids = self._ids(write)
        offset = skip * self.block_tokens
        span = table.capacity_tokens
        state: List[Any] = []
        for i, leaf in enumerate(flat):
            axis = self._seq_axis[i]
            if axis is None:
                state.append(leaf)
                continue
            if not write:
                continue
            lead = leaf.movedim(axis, 0)[offset:span]
            pages = lead.reshape((len(write), self.block_tokens)
                                 + tuple(lead.shape[1:]))
            self._pools[i][ids] = pages
        return state

    def store_prefix(self, table: PageTable, slot_cache,
                     n_tokens: int) -> None:
        """Persist a live slot's *full* blocks (the first
        `n_tokens // block_tokens` pages, minus the read-shared head)
        into the pool — called right after prefill so `register_prefix`
        publishes pages that actually hold the prompt's KV (ordinarily
        pages are only written at eviction)."""
        bt = self.block_tokens
        n_full = min(len(table.blocks), n_tokens // bt)
        skip = table.shared_blocks
        if n_full <= skip:
            return
        ids = self._ids(table.blocks[skip:n_full])
        for i, leaf in enumerate(self._flatten(slot_cache)):
            axis = self._seq_axis[i]
            if axis is None:
                continue
            lead = leaf.movedim(axis, 0)[skip * bt:n_full * bt]
            pages = lead.reshape((n_full - skip, bt) + tuple(lead.shape[1:]))
            self._pools[i][ids] = pages

    def register_prefix(self, prompt: List[int],
                        table: PageTable) -> None:
        """Publish a prefilled prompt's full blocks to the prefix index
        (no-op without one). Call after `store_prefix`."""
        if self.prefix is not None:
            self.prefix.register(prompt, table.blocks)

    # ------------------------------------------------------------------
    def export(self, table: PageTable) -> List[Optional[torch.Tensor]]:
        """The table's page contents, one `(n_blocks, block_tokens,
        *rest)` tensor per sequence leaf (None for non-sequence leaves) —
        the wire format of a KV migration."""
        ids = self._ids(table.blocks)
        return [None if pool is None else pool[ids]
                for pool in self._pools]

    def import_pages(self, pages: List[Optional[torch.Tensor]],
                     n_blocks: int) -> Optional[PageTable]:
        """Adopt migrated pages into this pool: allocate `n_blocks`
        fresh blocks and scatter each exported leaf in. None under pool
        exhaustion (the caller falls back to re-prefill)."""
        ids = self._allocate_fresh(n_blocks)
        if ids is None:
            return None
        idx = self._ids(ids)
        for i, leaf in enumerate(pages):
            if leaf is None:
                continue
            self._pools[i][idx] = leaf.to(self.device)
        return PageTable(blocks=ids, block_tokens=self.block_tokens)

    def load(self, table: PageTable, state: List[Any]):
        """Gather `table`'s pages back into a dense single-slot cache.

        Sequence positions past the table's span are zeros; decode masks
        them by position exactly as it masks never-written tail slots."""
        ids = self._ids(table.blocks)
        flat: List[Any] = []
        state_it = iter(state)
        for i, axis in enumerate(self._seq_axis):
            if axis is None:
                flat.append(next(state_it))
                continue
            pool = self._pools[i]
            pages = pool[ids]                       # (nb, bt, *rest)
            lead = pages.reshape((-1,) + tuple(pages.shape[2:]))
            rest = tuple(pool.shape[2:])
            full = torch.zeros((self.max_seq,) + rest, dtype=pool.dtype,
                               device=pool.device)
            full[: lead.shape[0]] = lead
            flat.append(full.movedim(0, axis).contiguous())
        out = _unflatten_cache(self._structure, flat)
        return out if self.ctx is None else PAR.ShardedCache(out,
                                                             self._spec_tree)

    # ------------------------------------------------------------------
    def _ids(self, blocks: List[int]) -> torch.Tensor:
        return torch.tensor(blocks, dtype=torch.long, device=self.device)

    def _leaf_names(self) -> List[Tuple[int, str]]:
        return [(layer, key) for layer, keys in self._structure
                for key in keys]

    def _flatten(self, slot_cache) -> List[Any]:
        flat, structure = _flatten_cache(slot_cache)
        if structure != self._structure:
            raise ValueError(
                f"slot cache structure {structure} does not match the "
                f"pool's {self._structure}")
        return flat


def _flatten_cache(cache) -> Tuple[List[Any], Tuple]:
    """A per-layer list of cache dicts -> (leaves, structure), the leaves
    of each layer in sorted key order (as `jax.tree.flatten` orders a
    dict's)."""
    structure = tuple((i, tuple(sorted(layer))) for i, layer
                      in enumerate(cache))
    flat = [cache[i][key] for i, keys in structure for key in keys]
    return flat, structure


def _unflatten_cache(structure, flat: List[Any]):
    it = iter(flat)
    return [{key: next(it) for key in keys} for _, keys in structure]
