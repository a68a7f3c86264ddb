"""Paged KV-cache management: block pool, page tables, COW prefix reuse.

The host-side policy half of the paged serving layout (the device half is
ops/inc_attention.py's paged op + kernels/flash_attention.py's paged
decode kernel). vLLM/PagedAttention (SOSP '23, PAPERS.md) is the
grounding: KV rows live in fixed-size BLOCKS drawn from one shared pool;
each slot owns a PAGE TABLE mapping its logical block index to a physical
block. Three consequences this module implements:

- **allocation at block granularity** — a slot holds ceil(length/bs)
  blocks, not max_seq rows, so short generations stop paying long-context
  HBM and the pool (not slots × max_seq) bounds concurrency;
- **prefix sharing via a radix tree** (radix.RadixPrefixCache) — prompt
  blocks are published into a token-labelled radix tree at prefill
  completion, keyed on the PROMPT extent only (K/V of a row depends on
  every token before it, so tree position is the content address); a new
  request maps the longest cached extent — including a partial match
  inside one block — into its own table (refcount++) and skips
  recomputing it. Each cached node holds one refcount on its block (the
  CACHE PIN), so prefixes SURVIVE their residents: sharing is
  cross-time, not just among live slots;
- **copy-on-write** — a write (decode append, or a prompt tail diverging
  inside a shared block) targeting a block with more than one reference
  first copies it to a fresh block (`CopyPlan` — the engine runs the
  device-side block copy). The pin makes every cached block
  COW-protected: a decode extending past its prompt can never overwrite
  cached prompt content (the poisoning the old full-prefix registry
  allowed), it pays one copy and owns the fresh block.

Physical block 0 is the RESERVED SCRATCH BLOCK (never allocated, never
freed): unallocated page-table entries point at it, and the device op
routes position-clipped writes there — the paged equivalent of the
contiguous layout's scratch row.

Pool pressure: admission reserves each request's worst case against the
FREE list (Σ reservations <= free blocks at all times, so a decode write
can NEVER exhaust the pool mid-flight); when the free list is too small,
`reserve` first EVICTS cold cache leaves LRU-first (radix.evict_lru) —
an evicted node only frees its block when the pin was the last
reference; a block a live slot still maps merely leaves the cache.
`cross_time=False` reproduces the old live-residents-only sharing (the
pin is dropped as the last holder releases) — the bench ablation.

Pure host code (no torch): a copy of `flexflow_tpu/serving/paged.py`,
unit-testable without a device.
"""

from __future__ import annotations

from dataclasses import dataclass

from .radix import RadixPrefixCache

SCRATCH_BLOCK = 0


@dataclass
class CopyPlan:
    """One COW copy the engine must run on the pool state BEFORE the next
    device step writes: physical block `src` duplicated into `dst`."""

    src: int
    dst: int


@dataclass
class PagedStats:
    prefix_queries: int = 0        # admissions that attempted a match
    prefix_hits: int = 0           # admissions that shared >= 1 token
    shared_tokens: int = 0         # prompt tokens served from shared blocks
    prompt_tokens: int = 0         # total prompt tokens admitted
    cow_copies: int = 0
    blocks_in_use_peak: int = 0    # peak LIVE blocks (cache-only excluded)
    cross_time_hits: int = 0       # hits where a matched block had no
    #                                live holder — served from the cache
    #                                after its residents exited
    radix_evictions: int = 0       # nodes evicted (LRU or pin-drop)
    radix_evicted_blocks: int = 0  # blocks actually freed by eviction

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens whose K/V came from a shared
        block instead of being recomputed and re-stored."""
        if self.prompt_tokens == 0:
            return 0.0
        return self.shared_tokens / self.prompt_tokens


class BlockManager:
    """Refcounted block pool + per-slot page tables + radix prefix cache.

    `refcount(blk)` reports LIVE holders (slots mapping the block); the
    cache pin is internal bookkeeping and excluded. `blocks_in_use`
    likewise counts live blocks only — a drained pool reads 0 even while
    the cache retains (evictable) blocks.
    """

    def __init__(self, num_blocks: int, block_size: int, table_width: int,
                 sharing: bool = True, cross_time: bool = False):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (scratch + 1 allocatable), got "
                f"{num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.table_width = int(table_width)
        self.sharing = bool(sharing)  # False = paged-without-reuse ablation
        self.cross_time = bool(cross_time)  # False = live sharing only
        # LIFO free list: hot blocks are reused while still cached
        self._free = list(range(num_blocks - 1, 0, -1))
        # RAW references: live slot mappings + (if cached) one cache pin
        self._refcount: dict[int, int] = {}
        self._live = 0  # blocks with >= 1 live (non-pin) reference
        # admission reservations (worst-case fresh blocks per resident),
        # keyed by request id until bind_reservation moves the key to the
        # slot index: Σ reservations <= free blocks at all times, so a
        # decode write can NEVER exhaust the pool mid-flight — admission
        # is the only place pool pressure is felt (FCFS head-blocking)
        self._reserved: dict = {}
        # slot index -> logical->physical list (allocated prefix only)
        self._tables: dict[int, list[int]] = {}
        self.cache = RadixPrefixCache(block_size) if self.sharing else None
        self.stats = PagedStats()

    # ------------------------------------------------------------ queries

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        """Blocks held by at least one live slot (cache-only excluded)."""
        return self._live

    @property
    def cached_blocks(self) -> int:
        """Blocks the radix cache holds a pin on (live-shared or not)."""
        return 0 if self.cache is None else len(self.cache.pinned)

    @property
    def cached_only_blocks(self) -> int:
        """Cached blocks whose pin is the sole reference — the evictable
        set the admission gate can reclaim."""
        if self.cache is None:
            return 0
        return sum(1 for b in self.cache.pinned
                   if self._refcount.get(b, 0) == 1)

    def table(self, slot: int) -> list[int]:
        """The slot's page table padded to table_width with SCRATCH (the
        row the engine feeds the device op)."""
        t = self._tables.get(slot, [])
        return t + [SCRATCH_BLOCK] * (self.table_width - len(t))

    def _pinned(self, block: int) -> bool:
        return self.cache is not None and block in self.cache.pinned

    def refcount(self, block: int) -> int:
        """LIVE holders of `block` (the cache pin is excluded)."""
        rc = self._refcount.get(block, 0)
        return rc - 1 if rc and self._pinned(block) else rc

    def blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case fresh blocks a request can consume over its life:
        every block of [0, prompt + new), CAPPED at the logical capacity
        (table_width) — generation physically stops at max_seq rows (the
        scheduler's `length` completion rule), so a huge max_new_tokens
        must not inflate the reservation past what the slot can ever
        write. Prefix sharing only ever LOWERS the real draw (a slot's
        shared blocks cost nothing, and at most one COW replaces a shared
        block with a fresh one), so reserving this at admission makes
        mid-flight exhaustion impossible."""
        return min(-(-(prompt_len + max_new_tokens) // self.block_size),
                   self.table_width)

    @property
    def reserved_total(self) -> int:
        return sum(self._reserved.values())

    def reserve(self, request_id, prompt_len: int,
                max_new_tokens: int) -> bool:
        """Admission gate: reserve the request's worst case against the
        pool, evicting cold cache leaves first when the free list alone
        cannot cover it. False = not enough headroom even after eviction
        (the caller keeps the request queued — FCFS head-blocking, so
        admission order never depends on pool pressure in a way that
        could reorder token streams)."""
        needed = self.blocks_needed(prompt_len, max_new_tokens)
        headroom = self.free_blocks - self.reserved_total
        if headroom < needed:
            self._evict_blocks(needed - headroom)
        if self.free_blocks - self.reserved_total < needed:
            return False
        self._reserved[("req", request_id)] = needed
        return True

    def bind_reservation(self, request_id, slot: int):
        """Move an admission reservation onto the slot that won it (the
        scheduler assigns slots after the gate passes)."""
        n = self._reserved.pop(("req", request_id), None)
        if n is not None:
            self._reserved[slot] = n

    # --------------------------------------------------------- refcounts

    def _map(self, block: int):
        """One more live holder of `block`."""
        if self.refcount(block) == 0:
            self._live += 1
        self._refcount[block] = self._refcount.get(block, 0) + 1

    def _unmap(self, block: int):
        """One live holder of `block` gone; frees at zero references."""
        if self.refcount(block) == 1:
            self._live -= 1
        n = self._refcount[block] - 1
        if n == 0:
            del self._refcount[block]
            self._free.append(block)
        else:
            self._refcount[block] = n

    def _unpin_free(self, block: int):
        """Drop the cache pin's reference (the node is already out of the
        cache); frees at zero."""
        n = self._refcount[block] - 1
        if n == 0:
            del self._refcount[block]
            self._free.append(block)
        else:
            self._refcount[block] = n

    def _evict_blocks(self, need: int) -> int:
        """Evict LRU cache leaves until `need` blocks are freed (or the
        cache runs out of freeable nodes). A victim whose block a live
        slot still maps frees nothing — it only leaves the cache (and
        unblocks a freeable ancestor)."""
        if self.cache is None or need <= 0:
            return 0
        freed = 0
        while freed < need:
            before = len(self._free)
            blk = self.cache.evict_lru(
                lambda b: self._refcount.get(b, 0) == 1)
            if blk is None:
                break
            self._unpin_free(blk)
            self.stats.radix_evictions += 1
            if len(self._free) > before:
                freed += 1
                self.stats.radix_evicted_blocks += 1
        return freed

    # ------------------------------------------------------------ intake

    def match_prefix(self, prompt) -> int:
        """Covered token count of the longest cached extent of `prompt`
        (a pure peek: no stats, no LRU touch)."""
        if self.cache is None:
            return 0
        return self.cache.match(prompt, peek=True)[0]

    def admit(self, slot: int, prompt: list[int]) -> int:
        """Build `slot`'s page table: map every block of the longest
        cached extent (refcount++), leave the rest for prefill writes to
        allocate. Called LAZILY — at the slot's first prefill chunk, not
        at admission — so a burst of same-prefix requests still shares:
        by the time the second request prefills, the first has computed
        and registered its blocks. Returns the prefill cursor: prompt
        tokens whose K/V need no recomputation, capped at len(prompt) - 1
        because the final token's logits row samples the first generated
        token (its re-write into a fully-shared block is the first
        COW)."""
        if slot in self._tables:
            raise ValueError(f"slot {slot} already holds a table")
        L = len(prompt)
        self.stats.prefix_queries += 1
        if self.cache is not None:
            covered, blocks = self.cache.match(prompt)
        else:
            covered, blocks = 0, []
        # a matched block with no live holder was served across time —
        # its residents exited and only the cache pin kept it
        cross = any(self._refcount.get(b, 0) == 1 for b in blocks)
        table: list[int] = []
        for blk in blocks:
            # full blocks, plus a partially-matched tail (mapped
            # read-only; the first write into it COWs under the pin)
            self._map(blk)
            table.append(blk)
        self._tables[slot] = table
        skip = min(covered, L - 1)
        self.stats.prompt_tokens += L
        self.stats.shared_tokens += skip
        if skip:
            self.stats.prefix_hits += 1
            if cross:
                self.stats.cross_time_hits += 1
        self._note_peak()
        return skip

    # ------------------------------------------------------------ writes

    def _note_peak(self):
        if self._live > self.stats.blocks_in_use_peak:
            self.stats.blocks_in_use_peak = self._live

    def _alloc(self, slot: int) -> int:
        if not self._free:
            # the admission reservations make this unreachable; evict
            # rather than die if an embedder drives the manager directly
            self._evict_blocks(1)
        if not self._free:
            raise RuntimeError(
                "paged KV pool exhausted — the admission reservations "
                "(reserve/blocks_needed) must prevent this")
        blk = self._free.pop()
        self._refcount[blk] = 1
        self._live += 1
        if slot in self._reserved:
            self._reserved[slot] = max(0, self._reserved[slot] - 1)
        self._note_peak()
        return blk

    def ensure_writable(self, slot: int, positions) -> list[CopyPlan]:
        """Guarantee every logical block covering `positions` is owned
        solely (one live reference, no pin) by `slot`, allocating fresh
        blocks past the table end and COW-copying referenced ones.
        Returns the copies the engine must apply to the device pool
        BEFORE the step that writes. A CACHED block always COWs (the pin
        keeps its raw count above one), so published prompt content is
        immutable — decode extension can never poison the cache."""
        table = self._tables.get(slot)
        if table is None:
            raise ValueError(f"slot {slot} has no table")
        bs = self.block_size
        copies: list[CopyPlan] = []
        for lb in sorted({int(p) // bs for p in positions}):
            if lb >= self.table_width:
                raise ValueError(
                    f"position past the logical capacity "
                    f"({self.table_width * bs} rows)")
            while len(table) <= lb:
                table.append(self._alloc(slot))
            blk = table[lb]
            if self._refcount.get(blk, 0) > 1:
                fresh = self._alloc(slot)
                self._unmap(blk)
                table[lb] = fresh
                copies.append(CopyPlan(src=blk, dst=fresh))
                self.stats.cow_copies += 1
                self._maybe_drop_cached(blk)
        return copies

    def register_prompt(self, slot: int, prompt: list[int]):
        """Publish `slot`'s prompt blocks into the radix cache (called
        once when its prefill completes), keyed on the PROMPT extent only
        — decode-written rows are never published (any later write into a
        published block COWs away from it). Exact-run incumbents keep
        their entry; newly inserted nodes pin their blocks."""
        if self.cache is None:
            return
        table = self._tables.get(slot, [])
        for blk in self.cache.insert(prompt, table):
            self._refcount[blk] = self._refcount.get(blk, 0) + 1

    # ------------------------------------------------------------ release

    def release(self, slot: int):
        """Drop the slot's table; refcounts decrement and blocks reaching
        zero references return to the free list. With `cross_time` the
        cache keeps its pinned blocks (that is the point — the prefix
        outlives the resident); without it, a block left holding only its
        pin is dropped from the cache and freed immediately (the old
        live-residents-only semantics)."""
        self._reserved.pop(slot, None)
        table = self._tables.pop(slot, None)
        if table is None:
            return
        for blk in table:
            self._unmap(blk)
            self._maybe_drop_cached(blk)

    def _maybe_drop_cached(self, block: int):
        """Without `cross_time`, a block left holding only its cache pin
        is dropped and freed on the spot — the old live-residents-only
        sharing semantics (a prefix dies with its last holder)."""
        if (not self.cross_time and self.cache is not None
                and self._refcount.get(block, 0) == 1
                and block in self.cache.pinned):
            self.cache.drop_block(block)
            self.stats.radix_evictions += 1
            self.stats.radix_evicted_blocks += 1
            self._unpin_free(block)

    def check_invariants(self):
        """Debug/test hook: every block is free xor referenced, the
        scratch block is neither, table entries have a live reference,
        the live-block counter reproduces from the raw counts, and the
        radix tree agrees with the pin accounting."""
        free = set(self._free)
        assert SCRATCH_BLOCK not in free
        assert SCRATCH_BLOCK not in self._refcount
        assert not (free & set(self._refcount)), "block both free and live"
        for slot, table in self._tables.items():
            for blk in table:
                assert self.refcount(blk) >= 1, \
                    f"slot {slot} maps block {blk} with no live reference"
        counted = sum(1 for _ in self._refcount)
        assert counted + len(free) == self.num_blocks - 1, \
            "pool accounting leak"
        live = sum(1 for b in self._refcount if self.refcount(b) > 0)
        assert live == self._live, \
            f"live counter drifted: cached {self._live}, actual {live}"
        assert self.reserved_total <= self.free_blocks, \
            "reservations exceed the free pool"
        if self.cache is not None:
            self.cache.check_invariants()
            for blk in self.cache.pinned:
                assert self._refcount.get(blk, 0) >= 1, \
                    f"cache pins unreferenced block {blk}"
            if not self.cross_time:
                assert self.cached_only_blocks == 0, \
                    "cross_time off but cache retains resident-free blocks"
