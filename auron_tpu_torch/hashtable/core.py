"""Device-resident open-addressing hash table: the building blocks.

The port of ``auron_tpu.hashtable.core``, in PyTorch ops. The insert is
the reference's claim-owner round: every unresolved row probes its
cursor slot in lock-step; rows at unowned slots race through one
scatter-min of their row id (the claim); then every row gathers its
slot's owner and compares key words with it, so duplicates resolve in
the round their winner claims, and rows that meet another key advance
their cursor by an odd, hash-derived step (double hashing). The claims
array is the table update: slot contents are gathers of each slot's
winning row. After the full-width rounds the survivors are compacted
once (a packed sort of resolved-bit | row id) and finish in narrow
rounds over a bounded tail buffer.

Slot order, claims and resolved rows are bit-identical to the
reference's for the same hashes and words.

**uint64 as int64.** PyTorch has no unsigned 64-bit arithmetic, so
hashes and key words are held as int64 with the same bits, as in
``ops/hashing.py``. Equality does not care about sign. ``EMPTY`` is -1
(0xFFFF_FFFF_FFFF_FFFF). The probe base and step mask an arithmetic
``>> 32`` down to ``cap - 1 < 2^32``, which equals the unsigned shift.
Unsigned order is needed only where slots are sorted by hash
(``agg._export_kernel``).

**Word-major key words.** The reference's word matrix is [n, W]; here
it is [W, n], so gathering a slot's words is W one-dimensional gathers:
PyTorch's CUDA gather of narrow rows of an [n, W] matrix is far slower.

**Drop-mode scatters.** The reference scatters masked rows with
``mode="drop"`` to an out-of-range index. Here a masked row scatters the
reduction's identity (UNOWNED for the claims' min, 0 for a sum, the
neutral for min/max) to a slot of its own, which changes no value; one
shared spare entry would serialise all their atomics on one address.
Only ``first``'s plain store keeps one spare entry past the end.

**Host syncs.** The reference's ``lax.while_loop`` on ``jnp.any``
becomes a Python loop whose condition reads one bool from the device
each round. ``insert_loop.rounds`` / ``.syncs`` and ``probe_loop.rounds``
/ ``.syncs`` count the claim rounds run and the device reads made.

**String keys.** A string key column's words are its validity, its
length and ``width / 8`` little-endian words of its bytes (bytes at or
past the length, and every byte of a null row, masked to zero), and its
store keeps the chars, lengths and validity. A batch narrower than the
store is zero-padded up to it; a wider batch widens the store first
(``widen_string_store``): zero char words are spliced into the
word-major matrix at the end of the column's segment, which changes no
stored key's equality, and no slot moves.

**Decimal keys.** A decimal of precision <= 18 is a primitive int64 key;
a wider one (``("dec",)``) has three words, its validity, high limb and
low limb (zeroed on null rows), and its store keeps both limbs and the
validity.
"""

from __future__ import annotations

import torch

from auron_tpu_torch.columnar.batch import (Decimal128Column, PrimitiveColumn,
                                            StringColumn)
from auron_tpu_torch.ops.hashing import canonicalize_float
from auron_tpu_torch.ops.strings import le_words
from auron_tpu_torch.utils.float_order import scatter_min_max

#: empty-slot sentinel: the uint64 maximum, as int64 bits. It is the
#: agg path's hash sentinel, so exported tables keep dead slots last.
EMPTY = -1

#: claims-array sentinels: a slot is unowned, owned by a pre-existing
#: table entry, or owned by batch row id >= 0
UNOWNED = 0x7FFFFFFF
PREOWNED = -1

#: reduce kinds ``agg_update`` scatters exactly (bit-identical to the
#: sort path's segment reduction for any update order): integer adds are
#: associative, min/max/or are order-free, and ``first`` resolves through
#: a deterministic global row ordinal. Float sums are structurally
#: supported but reassociate; the dispatch policy keeps them off the
#: hash path unless auron.hashtable.backend=hash forces them.
SUPPORTED_KINDS = frozenset({"sum", "min", "max", "or", "first"})

_U32 = 0xFFFFFFFF


def remap_hashes(h: torch.Tensor) -> torch.Tensor:
    """Hashes with the (astronomically unlikely) EMPTY value moved to
    EMPTY-1, so it can never masquerade as an empty slot."""
    return torch.where(h == EMPTY, EMPTY - 1, h)


def _spare(a: torch.Tensor, fill) -> torch.Tensor:
    """A copy of ``a`` with one spare entry at index ``len(a)``, the
    target of masked rows' stores."""
    return torch.cat([a, a.new_full((1,), fill)])


# ---------------------------------------------------------------------------
# key codec
# ---------------------------------------------------------------------------

def dtype_name(dt: torch.dtype) -> str:
    """'int64', 'float32', 'bool', ...: numpy's names, as the reference's
    metadata spells them."""
    return str(dt).removeprefix("torch.")


def key_meta(cols) -> tuple:
    """Static per-column codec descriptor, enough to rebuild an empty
    store: ``("prim", dtype)``, ``("str", width)`` or ``("dec",)``.
    Raises NotImplementedError for columns without a word encoding in
    the port (nested types)."""
    meta = []
    for c in cols:
        if isinstance(c, StringColumn):
            meta.append(("str", int(c.width)))
        elif isinstance(c, Decimal128Column):
            meta.append(("dec",))
        elif isinstance(c, PrimitiveColumn):
            meta.append(("prim", dtype_name(c.data.dtype)))
        else:
            raise NotImplementedError(
                f"hashtable keys of {type(c).__name__} are not supported: "
                "the port encodes primitive, string and decimal key "
                "columns (nested keys: ROADMAP item 16f)")
    return tuple(meta)


def words_per_column(meta_entry) -> int:
    if meta_entry[0] == "prim":
        return 2                        # validity, canonical value
    if meta_entry[0] == "dec":
        return 3                        # validity, hi, lo
    # string: validity, length, ceil(width / 8) char words (widths are
    # bucketed to multiples of 8 — utils/shapes.bucket_string_width)
    return 2 + (meta_entry[1] + 7) // 8


def total_words(meta: tuple) -> int:
    return sum(words_per_column(m) for m in meta)


def _prim_word(col: PrimitiveColumn) -> torch.Tensor:
    """One canonical 64-bit word per row for a primitive column."""
    d = col.data
    if d.dtype == torch.float64:
        return canonicalize_float(d).view(torch.int64)
    if d.dtype == torch.float32:
        # zero-extended, as the reference widens through uint32
        return canonicalize_float(d).view(torch.int32).to(torch.int64) & _U32
    return d.to(torch.int64)


def _string_words(col: StringColumn) -> list[torch.Tensor]:
    """A string column's char words: little-endian 64-bit words of its
    bytes below each row's length (zero past it and on null rows)."""
    in_len = (torch.arange(col.width, dtype=torch.int32,
                           device=col.chars.device)[None, :]
              < col.lens[:, None]) & col.validity[:, None]
    return list(le_words(torch.where(in_len, col.chars, 0), 8).unbind(1))


def key_words(cols, meta: tuple) -> torch.Tensor:
    """int64[W, n] canonical equality words, word-major (zeroed where
    invalid, so null keys equal each other and nothing else)."""
    ws = []
    for c, m in zip(cols, meta):
        valid = c.validity
        ws.append(valid.to(torch.int64))
        if m[0] == "prim":
            ws.append(torch.where(valid, _prim_word(c), 0))
        elif m[0] == "dec":
            ws.append(torch.where(valid, c.hi, 0))
            ws.append(torch.where(valid, c.lo, 0))
        else:
            ws.append(torch.where(valid, c.lens.to(torch.int64), 0))
            ws.extend(_string_words(c))
    return torch.stack(ws)


def empty_store(meta: tuple, cap: int, device) -> tuple:
    """Slot-indexed original-value storage: one tuple of arrays per key
    column (the emit-side complement of the equality words)."""
    store = []
    for m in meta:
        if m[0] == "prim":
            store.append((torch.zeros(cap, dtype=getattr(torch, m[1]),
                                      device=device),
                          torch.zeros(cap, dtype=torch.bool, device=device)))
        elif m[0] == "dec":
            store.append(tuple(
                torch.zeros(cap, dtype=dt, device=device)
                for dt in (torch.int64, torch.int64, torch.bool)))
        else:
            store.append((torch.zeros((cap, m[1]), dtype=torch.uint8,
                                      device=device),
                          torch.zeros(cap, dtype=torch.int32, device=device),
                          torch.zeros(cap, dtype=torch.bool, device=device)))
    return tuple(store)


def _col_arrays(col, m) -> tuple:
    if m[0] == "prim":
        return (col.data, col.validity)
    if m[0] == "dec":
        return (col.hi, col.lo, col.validity)
    return (col.chars, col.lens, col.validity)


_STORE_COLUMN = {"prim": PrimitiveColumn, "dec": Decimal128Column,
                 "str": StringColumn}


def store_columns(store: tuple, meta: tuple) -> tuple:
    """Rebuild key columns from a store (slot-indexed)."""
    return tuple(_STORE_COLUMN[m[0]](*s) for s, m in zip(store, meta))


def widen_string_store(tw: torch.Tensor, store: tuple, meta: tuple,
                       new_widths: dict) -> tuple:
    """Grow string columns' width buckets: pad the stored chars and
    splice zero char words into the word-major matrix at the end of
    each widened column's segment (zero padding leaves hashes and the
    words of every stored key unchanged). Returns (tw, store, meta)."""
    blocks, out_meta, out_store = [], [], []
    off = 0
    for i, m in enumerate(meta):
        w = words_per_column(m)
        seg = tw[off:off + w]
        s = store[i]
        if i in new_widths:
            nw = new_widths[i]
            seg = torch.cat([seg, seg.new_zeros(((nw - m[1]) // 8,
                                                 seg.shape[1]))])
            s = (torch.nn.functional.pad(s[0], (0, nw - m[1])), s[1], s[2])
            m = ("str", nw)
        blocks.append(seg)
        out_meta.append(m)
        out_store.append(s)
        off += w
    return torch.cat(blocks), tuple(out_store), tuple(out_meta)


def string_width_drift(batch_meta: tuple, table_meta: tuple) -> dict:
    """{column index: new width} for batch string columns wider than the
    table's store; asserts every other shape aspect is stable."""
    widen = {}
    for i, (bm, sm) in enumerate(zip(batch_meta, table_meta)):
        if bm[0] != sm[0] or (bm[0] != "str" and bm != sm):
            raise AssertionError(
                f"hashtable key column {i} changed shape mid-stream: "
                f"{sm} -> {bm}")
        if bm[0] == "str" and bm[1] > sm[1]:
            widen[i] = bm[1]
    return widen


# ---------------------------------------------------------------------------
# install-by-gather (the claims array IS the update)
# ---------------------------------------------------------------------------

def batch_owned(claims: torch.Tensor) -> torch.Tensor:
    """bool[cap]: slots claimed by this batch (vs empty / pre-existing)."""
    return (claims != UNOWNED) & (claims != PREOWNED)


def table_install(table_h, table_w, h, w, claims):
    """Fold a finished claims map into (hashes, words): batch-won slots
    gather their winner's hash and words; no scatter touches the table."""
    won = batch_owned(claims)
    cw = claims.clamp(0, h.shape[0] - 1)
    th = torch.where(won, h[cw], table_h)
    tw = torch.where(won, w[:, cw], table_w)
    return th, tw


def store_install(store: tuple, cols, meta: tuple, claims) -> tuple:
    """Gather winners' original key values into batch-won slots."""
    won = batch_owned(claims)
    cw = claims.clamp(0, cols[0].validity.shape[0] - 1)

    def install(old, val):
        sel = won if old.dim() == 1 else won[:, None]
        return torch.where(sel, val[cw], old)

    return tuple(
        tuple(install(old, val) for old, val in zip(s, _col_arrays(c, m)))
        for s, c, m in zip(store, cols, meta))


# ---------------------------------------------------------------------------
# probe loops
# ---------------------------------------------------------------------------

def _probe_base_step(h: torch.Tensor, cap: int):
    """(base slot, odd step) per row, int64: double hashing over a
    power-of-two table. An odd step is coprime with 2^k, so every row's
    probe sequence visits all slots."""
    mask = cap - 1
    return h & mask, ((h >> 32) & mask) | 1


def _claim_round(claims, unresolved, pos, slot, rids, hh, ww, step,
                 table_h, table_w, h_all, w_all, cap: int):
    """One scatter-claim + gather-verify round over a row subset (the
    full batch or the compacted tail). ``claims`` (int32[cap]) is updated
    in place; ``rids`` index into the full batch arrays ``h_all``/``w_all``
    (owner equality gathers). Returns (unresolved, pos, slot)."""
    n = h_all.shape[0]
    claimant = unresolved & (claims[pos] == UNOWNED)
    # rows that do not claim offer UNOWNED, which changes no slot's min
    claims.scatter_reduce_(0, pos, torch.where(claimant, rids, UNOWNED),
                           "amin")
    owner = claims[pos]
    ow = owner.clamp(0, n - 1)
    by_batch = batch_owned(owner)
    own_h = torch.where(by_batch, h_all[ow], table_h[pos])
    own_w = torch.where(by_batch, w_all[:, ow], table_w[:, pos])
    match = (owner != UNOWNED) & (own_h == hh) & (own_w == ww).all(dim=0)
    resolved = unresolved & match
    slot = torch.where(resolved, pos, slot)
    unresolved = unresolved & ~resolved
    pos = torch.where(unresolved, (pos + step) & (cap - 1), pos)
    return unresolved, pos, slot


def _tail_capacity(n: int, tail_frac: int) -> int:
    """Tail-buffer size: generous enough that only genuinely
    pathological chains overflow it (the caller grows and retries)."""
    return n if n <= 4096 else max(4096, n // tail_frac)


def insert_loop(table_h: torch.Tensor, table_w: torch.Tensor,
                h: torch.Tensor, w: torch.Tensor, live: torch.Tensor,
                max_rounds: int, full_rounds: int = 2, tail_frac: int = 4):
    """Vectorized open-addressing insert.

    ``full_rounds`` claim rounds run at batch width; survivors compact
    once via a packed sort and finish in narrow rounds over a tail
    buffer, stopping as soon as every row is resolved or ``max_rounds``
    rounds have run in all.

    Returns (claims int32[cap], slot int32[n], resolved bool[n]). Slot
    contents derive from ``claims`` by gather (``table_install`` /
    ``store_install``). ``live & ~resolved`` rows exhausted the round
    budget or overflowed the tail buffer: the caller re-buckets and
    retries.
    """
    n = h.shape[0]
    cap = table_h.shape[0]
    dev = h.device
    # never place a key deeper than lookups are allowed to walk: a probe
    # with the same max_rounds must always be able to find it
    full_rounds = max(1, min(full_rounds, max_rounds))
    base, step = _probe_base_step(h, cap)
    rid = torch.arange(n, dtype=torch.int32, device=dev)
    # pre-existing entries own their slots before the batch arrives
    claims = torch.where(table_h != EMPTY, PREOWNED, UNOWNED).to(
        torch.int32)

    unresolved, pos = live, base
    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(full_rounds):
        unresolved, pos, slot = _claim_round(
            claims, unresolved, pos, slot, rid, h, w, step,
            table_h, table_w, h, w, cap)

    T = _tail_capacity(n, tail_frac)
    # compact survivors: resolved and dead rows sort behind the live
    # unresolved ones (the packed key is non-negative)
    packed = torch.where(unresolved, 0, 1 << 32) + rid
    srt = torch.sort(packed).values[:T]
    t_rid = srt & _U32
    t_live = (srt >> 32) == 0
    t_h, t_w = h[t_rid], w[:, t_rid]
    t_pos, t_step = pos[t_rid], step[t_rid]
    t_rid32 = t_rid.to(torch.int32)

    t_unres = t_live
    t_slot = torch.zeros(T, dtype=torch.int64, device=dev)
    for _ in range(full_rounds, max_rounds):
        insert_loop.syncs += 1
        if not bool(t_unres.any()):
            break
        insert_loop.rounds += 1
        t_unres, t_pos, t_slot = _claim_round(
            claims, t_unres, t_pos, t_slot, t_rid32, t_h, t_w, t_step,
            table_h, table_w, h, w, cap)
    insert_loop.rounds += full_rounds

    # t_rid holds distinct rows: write back only the ones the tail placed
    done = t_live & ~t_unres
    slot = slot.index_put((t_rid,), torch.where(done, t_slot, slot[t_rid]))
    resolved = ~unresolved & live
    resolved = resolved.index_put((t_rid,), resolved[t_rid] | done) & live
    # rows that did not fit the tail buffer stay unresolved
    return claims, slot.to(torch.int32), resolved


insert_loop.rounds = 0
insert_loop.syncs = 0


def probe_loop(table_h: torch.Tensor, table_w: torch.Tensor,
               h: torch.Tensor, w: torch.Tensor, live: torch.Tensor,
               max_rounds: int):
    """Lookup-only probe: walks the same double-hashed sequence as
    ``insert_loop``; an empty slot proves absence (open addressing never
    deletes). Scatter-free. Returns (slot int32[n], found bool[n])."""
    n = h.shape[0]
    cap = table_h.shape[0]
    base, step = _probe_base_step(h, cap)
    unresolved, pos = live, base
    slot = torch.zeros(n, dtype=torch.int64, device=h.device)
    found = torch.zeros(n, dtype=torch.bool, device=h.device)
    for _ in range(max_rounds):
        probe_loop.syncs += 1
        if not bool(unresolved.any()):
            break
        probe_loop.rounds += 1
        slot_h = table_h[pos]
        occupied = slot_h != EMPTY
        match = occupied & (slot_h == h) & \
            (table_w[:, pos] == w).all(dim=0)
        hit = unresolved & match
        slot = torch.where(hit, pos, slot)
        # keep walking only past occupied non-matching slots
        unresolved = unresolved & occupied & ~match
        pos = torch.where(unresolved, (pos + step) & (cap - 1), pos)
        found = found | hit
    return slot.to(torch.int32), found


probe_loop.rounds = 0
probe_loop.syncs = 0


def probe_hash_index(table_h: torch.Tensor, h: torch.Tensor,
                     live: torch.Tensor, max_rounds: int):
    """Degenerate probe for tables keyed on the 64-bit hash alone (the
    join candidate index): equality is the hash compare, no words."""
    w = h.new_zeros((0, h.shape[0]))
    return probe_loop(table_h, table_h.new_zeros((0, table_h.shape[0])),
                      h, w, live, max_rounds)


# ---------------------------------------------------------------------------
# slot-indexed accumulator update
# ---------------------------------------------------------------------------

def neutral_like(kind: str, dtype: torch.dtype) -> torch.Tensor:
    """Neutral element (a 0-d CPU tensor) of a reduce kind for
    acc-array initialization."""
    if kind in ("sum", "first"):
        return torch.zeros((), dtype=dtype)
    if kind in ("min", "max"):
        if dtype.is_floating_point:
            v = float("inf") if kind == "min" else float("-inf")
        else:
            info = torch.iinfo(dtype)
            v = info.max if kind == "min" else info.min
        return torch.tensor(v, dtype=dtype)
    if kind == "or":
        return torch.zeros((), dtype=torch.bool)
    raise ValueError(kind)


#: ordinal sentinel for first-kind aux arrays (no row yet)
ORD_NONE = 0x7FFFFFFFFFFFFFFF


def init_accs(acc_meta: tuple, cap: int, device):
    """(accs, auxs): neutral acc array per (kind, dtype); first-kind accs
    get a parallel int64 ordinal array (global first-row tracking)."""
    accs, auxs = [], []
    for kind, dt in acc_meta:
        neutral = neutral_like(kind, getattr(torch, dt))
        accs.append(torch.full((cap,), neutral.item(), dtype=neutral.dtype,
                               device=device))
        auxs.append(torch.full((cap,), ORD_NONE, dtype=torch.int64,
                               device=device) if kind == "first" else None)
    return tuple(accs), tuple(auxs)


def agg_update(accs: tuple, auxs: tuple, acc_meta: tuple,
               slot: torch.Tensor, mask: torch.Tensor, contribs: tuple,
               ord_base: int) -> tuple:
    """Fold one batch's per-row contributions into slot-indexed
    accumulators, returning new arrays (the inputs are not changed).
    ``mask`` selects resolved live rows; ``ord_base`` is the global row
    ordinal of this batch's first row, which makes ``first``
    deterministic across batches: the accumulator keeps the value at the
    minimum ordinal (first batch, first row)."""
    if not accs:
        return (), ()
    cap = accs[0].shape[0]
    n = slot.shape[0]
    rid = torch.arange(n, dtype=torch.int64, device=slot.device)
    # masked rows reduce the identity into a slot spread by row id
    pos = torch.where(mask, slot.to(torch.int64), rid % cap)
    out_accs, out_auxs = [], []
    for (kind, _dt), acc, aux, v in zip(acc_meta, accs, auxs, contribs):
        if kind == "sum":
            # + 0 changes no sum: a float acc, starting at +0.0, is never
            # -0.0 under round-to-nearest
            out_accs.append(acc.clone().index_add_(
                0, pos, torch.where(mask, v, 0)))
            out_auxs.append(None)
        elif kind in ("min", "max"):
            # contributions already carry the reduce neutral where the
            # row's value is invalid; masked rows carry it too
            neutral = neutral_like(kind, v.dtype).item()
            out_accs.append(scatter_min_max(
                acc, pos, torch.where(mask, v, neutral), kind))
            out_auxs.append(None)
        elif kind == "or":
            hits = torch.zeros(cap, dtype=torch.int32,
                               device=acc.device).index_add_(
                0, pos, (mask & v.bool()).to(torch.int32))
            out_accs.append(acc | (hits > 0))
            out_auxs.append(None)
        elif kind == "first":
            ordinal = torch.where(mask, rid + ord_base, ORD_NONE)
            new_aux = aux.clone().scatter_reduce_(0, pos, ordinal, "amin")
            # row ordinals are unique, so exactly one row writes per slot
            setter = mask & (ordinal == new_aux[slot])
            new_acc = _spare(acc, 0)
            new_acc[torch.where(setter, pos, cap)] = v
            out_accs.append(new_acc[:cap])
            out_auxs.append(new_aux)
        else:
            raise ValueError(kind)
    return tuple(out_accs), tuple(out_auxs)
