"""Spark string functions as device tensor ops.

The port of ``auron_tpu.exprs.fn_strings``. On the fixed-width (chars
[n, w], lens [n]) layout every function is a masked gather over the char
matrix; a function whose output length depends on the data (translate
with deletions, substring_index) computes a per-row keep mask or cut
and gathers once. A search compares every start position at once
(``ops.strings.window_hits``); only ``substring_index`` with a delimiter
of two or more bytes walks the start positions in order, since there a
hit inside an earlier occurrence does not count. ``split(...)[i]`` runs
on the host (``exprs/host.py``).

Registered into the shared scalar-function registry (exprs/functions.py).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import PrimitiveColumn, StringColumn
from auron_tpu_torch.columnar.schema import DataType
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import TypedValue, cast_value, evaluate
from auron_tpu_torch.exprs.functions import (literal_arg, register,
                                             string_result)
from auron_tpu_torch.exprs.host import decode, host_map
from auron_tpu_torch.ops import strings as S
from auron_tpu_torch.utils.shapes import bucket_string_width


def _bytes(v) -> bytes:
    return v.encode() if isinstance(v, str) else (v or b"")


def _string(chars, lens, validity) -> TypedValue:
    return TypedValue(StringColumn(chars, lens, validity), DataType.STRING)


def _empty(n: int, validity) -> TypedValue:
    dev = validity.device
    return _string(torch.zeros((n, 8), dtype=torch.uint8, device=dev),
                   torch.zeros(n, dtype=torch.int32, device=dev), validity)


# ---------------------------------------------------------------------------
# concat_ws / initcap / repeat / reverse / pads
# ---------------------------------------------------------------------------

@register("concat_ws", string_result)
def _concat_ws(args, expr, batch, schema, ctx):
    """concat_ws(sep, s1, s2, ...): null args are SKIPPED (unlike concat);
    the result is null only when sep is null (Spark semantics)."""
    sep, parts = args[0], args[1:]
    if not parts:
        return _empty(batch.capacity, sep.validity)
    n = parts[0].col.capacity
    sep_c: StringColumn = sep.col
    total_w = sum(p.col.width for p in parts) + \
        sep_c.width * max(len(parts) - 1, 0)
    out_w = bucket_string_width(max(total_w, 1))
    dev = sep_c.chars.device
    out = torch.zeros((n, out_w), dtype=torch.uint8, device=dev)
    pos = torch.zeros(n, dtype=torch.int32, device=dev)
    written_any = torch.zeros(n, dtype=torch.bool, device=dev)
    for p in parts:
        inc = p.validity
        # separator before this part if something was already written
        out, pos = S.place(out, pos, sep_c.chars, sep_c.lens,
                           inc & written_any)
        out, pos = S.place(out, pos, p.col.chars, p.col.lens, inc)
        written_any = written_any | inc
    return _string(out, torch.where(sep.validity, pos, 0), sep.validity)


@register("initcap", string_result)
def _initcap(args, expr, batch, schema, ctx):
    """Uppercase the first letter of each space-separated word, lowercase
    the rest (Spark initcap, ASCII)."""
    c = args[0].col.chars
    lo = torch.where((c >= ord("A")) & (c <= ord("Z")), c + 32, c)
    # word start: position 0, or the previous char is a space
    prev = torch.nn.functional.pad(lo[:, :-1], (1, 0), value=ord(" "))
    start = prev == ord(" ")
    up = torch.where(start & (lo >= ord("a")) & (lo <= ord("z")), lo - 32,
                     lo)
    return _string(up, args[0].col.lens, args[0].validity)


@register("repeat", string_result)
def _repeat(args, expr, batch, schema, ctx):
    v = args[0]
    times = int(literal_arg(expr, 1, 1) or 0)
    w = v.col.width
    n = v.col.capacity
    if times <= 0:
        return _empty(n, v.validity)
    out_w = bucket_string_width(w * times)
    # tile positions: out[j] = chars[j mod len] for j < len*times
    out_pos = S.positions(out_w, v.col.chars.device)
    src = torch.remainder(out_pos, v.col.lens.clamp(min=1)[:, None])
    gathered = torch.gather(v.col.chars, 1, src.clamp(0, w - 1).long())
    out_len = v.col.lens * times
    return _string(S.masked(gathered, out_len), out_len, v.validity)


@register("reverse", string_result)
def _reverse(args, expr, batch, schema, ctx):
    v = args[0]
    chars, lens = v.col.chars, v.col.lens
    w = chars.shape[1]
    idx = lens[:, None] - 1 - S.positions(w, chars.device)
    out = torch.gather(chars, 1, idx.clamp(0, w - 1).long())
    return _string(S.masked(out, lens), lens, v.validity)


def _pad(args, expr, left: bool) -> TypedValue:
    v = args[0]
    target = int(literal_arg(expr, 1, 0) or 0)
    pad_b = _bytes(literal_arg(expr, 2, " ")) or b" "
    chars, lens = v.col.chars, v.col.lens
    dev = chars.device
    w = chars.shape[1]
    out_w = bucket_string_width(max(target, 1))
    # Spark gives every row the target length (the string cut or padded)
    out_len = torch.full_like(lens, target)
    pad_arr = S.literal_tensor(pad_b, dev)
    plen = len(pad_b)
    pos = S.positions(out_w, dev)
    src = torch.nn.functional.pad(chars, (0, max(out_w - w, 0)))[:, :out_w]
    if left:
        npad = (target - lens).clamp(min=0)[:, None]
        pad_chars = pad_arr[torch.remainder(pos, plen).long()]
        str_chars = torch.gather(src, 1, (pos - npad).clamp(0, out_w - 1)
                                 .long())
        out = torch.where(pos < npad, pad_chars, str_chars)
    else:
        pad_chars = pad_arr[torch.remainder(pos - lens[:, None], plen)
                            .long()]
        out = torch.where(pos < lens[:, None], src, pad_chars)
    return _string(S.masked(out, out_len), out_len, v.validity)


@register("lpad", string_result)
def _lpad(args, expr, batch, schema, ctx):
    return _pad(args, expr, left=True)


@register("rpad", string_result)
def _rpad(args, expr, batch, schema, ctx):
    return _pad(args, expr, left=False)


@register("left", string_result)
def _left(args, expr, batch, schema, ctx):
    ln = cast_value(args[1], DataType.INT32).data
    return TypedValue(S.substring(args[0].col, torch.ones_like(ln),
                                  ln.clamp(min=0)), DataType.STRING)


@register("right", string_result)
def _right(args, expr, batch, schema, ctx):
    v = args[0]
    ln = cast_value(args[1], DataType.INT32).data.clamp(min=0)
    start = torch.where(ln == 0, v.col.lens + 1, -ln)
    return TypedValue(S.substring(v.col, start,
                                  torch.full_like(ln, 2 ** 30)),
                      DataType.STRING)


@register("space", string_result)
def _space(args, expr, batch, schema, ctx):
    # literal-only: the output width must be static (a silent cap on a
    # column argument would truncate data)
    nsp = cast_value(args[0], DataType.INT32).data.clamp(min=0)
    out_w = bucket_string_width(max(int(literal_arg(expr, 0, 0) or 0), 1))
    nsp = nsp.clamp(max=out_w)
    mask = S.positions(out_w, nsp.device) < nsp[:, None]
    chars = torch.where(mask, ord(" "), 0).to(torch.uint8)
    return _string(chars, nsp, args[0].validity)


@register("ascii", DataType.INT32)
def _ascii(args, expr, batch, schema, ctx):
    v = args[0]
    first = torch.where(v.col.lens > 0, v.col.chars[:, 0].to(torch.int32),
                        0)
    return TypedValue(PrimitiveColumn(first, v.validity), DataType.INT32)


@register("chr", string_result)
@register("char", string_result)
def _chr(args, expr, batch, schema, ctx):
    code = torch.remainder(cast_value(args[0], DataType.INT64).data, 256)
    n = args[0].validity.shape[0]
    chars = torch.zeros((n, 8), dtype=torch.uint8, device=code.device)
    chars[:, 0] = code.to(torch.uint8)
    return _string(chars, (code > 0).to(torch.int32), args[0].validity)


# ---------------------------------------------------------------------------
# search: instr / locate / substring_index / translate
# ---------------------------------------------------------------------------

def _first_occurrence(chars, lens, needle: bytes, from_pos):
    """1-based position of the first occurrence of ``needle`` at or after
    0-based ``from_pos``; 0 when absent."""
    n, w = chars.shape
    m = len(needle)
    if m == 0:
        return torch.minimum(from_pos + 1, lens + 1).to(torch.int32)
    if m > w:
        return torch.zeros(n, dtype=torch.int32, device=chars.device)
    hits = S.window_hits(chars, lens, needle)
    s = S.positions(hits.shape[1], chars.device)
    best = torch.where(hits & (s >= from_pos[:, None]), s, w + 1).amin(dim=1)
    return torch.where(best <= w, best + 1, 0).to(torch.int32)


@register("instr", DataType.INT32)
def _instr(args, expr, batch, schema, ctx):
    v = args[0]
    p = _first_occurrence(v.col.chars, v.col.lens, _bytes(literal_arg(expr, 1, "")),
                          torch.zeros_like(v.col.lens))
    return TypedValue(PrimitiveColumn(p, v.validity & args[1].validity),
                      DataType.INT32)


@register("locate", DataType.INT32)
@register("position", DataType.INT32)
def _locate(args, expr, batch, schema, ctx):
    # locate(substr, str[, pos])
    needle = _bytes(literal_arg(expr, 0, ""))
    v = args[1]
    start = (cast_value(args[2], DataType.INT32).data - 1
             if len(args) > 2 else torch.zeros_like(v.col.lens))
    p = _first_occurrence(v.col.chars, v.col.lens, needle,
                          start.clamp(min=0))
    return TypedValue(PrimitiveColumn(p, v.validity), DataType.INT32)


def _occurrences(chars, lens, delim: bytes) -> torch.Tensor:
    """bool [n, w]: the starts of the delimiter's occurrences, taken left
    to right without overlap (Java's indexOf stepping by its length)."""
    n, w = chars.shape
    m = len(delim)
    hits = S.window_hits(chars, lens, delim)
    hits = torch.nn.functional.pad(hits, (0, w - hits.shape[1]))
    if m == 1:
        return hits
    occ = torch.zeros_like(hits)
    blocked_until = torch.zeros(n, dtype=torch.int32, device=chars.device)
    for s in range(w - m + 1):
        hit = hits[:, s] & (s >= blocked_until)
        occ[:, s] = hit
        blocked_until = torch.where(hit, s + m, blocked_until)
    return occ


@register("substring_index", string_result)
def _substring_index(args, expr, batch, schema, ctx):
    """substring_index(str, delim, count): everything before the count-th
    delimiter (count > 0, from the left) or after it (count < 0, from the
    right); the whole string when there are too few delimiters."""
    v = args[0]
    delim = _bytes(literal_arg(expr, 1, ""))
    count = int(literal_arg(expr, 2, 0) or 0)
    chars, lens = v.col.chars, v.col.lens
    n, w = chars.shape
    m = len(delim)
    if m == 0 or count == 0:
        return _string(torch.zeros_like(chars), torch.zeros_like(lens),
                       v.validity)
    if m > w:
        # no occurrence fits: the whole string
        return _string(S.masked(chars, lens), lens, v.validity)
    occ = _occurrences(chars, lens, delim)
    pos = S.positions(w, chars.device)
    cum = torch.cumsum(occ.to(torch.int32), dim=1)
    total = cum[:, -1]
    if count > 0:
        # cut before the count-th occurrence
        cut = torch.where(occ & (cum == count), pos, w).amin(dim=1)
        new_len = torch.where(total >= count, torch.minimum(cut, lens),
                              lens).to(torch.int32)
        return _string(S.masked(chars, new_len), new_len, v.validity)
    k = -count
    # start after the (total-k+1)-th occurrence from the left
    target = total - k + 1
    start_at = torch.where(occ & (cum == target[:, None]), pos,
                           -1).amax(dim=1) + m
    start = torch.where(total >= k, start_at, 0)
    new_len = lens - start
    out = S.shift_gather(chars, start, w)
    return _string(S.masked(out, new_len), new_len.clamp(min=0)
                   .to(torch.int32), v.validity)


@register("translate", string_result)
def _translate(args, expr, batch, schema, ctx):
    """translate(str, from, to): per-byte mapping through a 256-entry
    table; bytes beyond len(to) are DELETED, the rest compacted to the
    front by one argsort per row."""
    v = args[0]
    from_b = str(literal_arg(expr, 1, "")).encode()
    to_b = str(literal_arg(expr, 2, "")).encode()
    lut = np.arange(256, dtype=np.int32)        # identity
    delete = np.zeros(256, bool)
    for i, ch in enumerate(from_b):
        if lut[ch] != ch or delete[ch]:
            continue  # first occurrence wins (Java semantics)
        if i < len(to_b):
            lut[ch] = to_b[i]
        else:
            delete[ch] = True
    chars, lens = v.col.chars, v.col.lens
    dev = chars.device
    w = chars.shape[1]
    idx = chars.long()
    mapped = torch.from_numpy(lut).to(dev)[idx].to(torch.uint8)
    pos = S.positions(w, dev)
    drop = torch.from_numpy(delete).to(dev)[idx] | (pos >= lens[:, None])
    # stable compact per row: sort by (dropped, position)
    order = torch.argsort(torch.where(drop, w + pos, pos), dim=1)
    out = torch.gather(mapped, 1, order)
    new_len = (~drop).sum(dim=1).to(torch.int32)
    return _string(S.masked(out, new_len), new_len, v.validity)


# ---------------------------------------------------------------------------
# split (host) + fused element access
# ---------------------------------------------------------------------------

def split_index(child_args, ordinal: int, batch, schema, ctx):
    """GetIndexedField(split(str, regex), i) fused into one host function:
    the i-th piece, or null when out of range."""
    v = evaluate(child_args[0], batch, schema, ctx)
    pat = child_args[1]
    if not isinstance(pat, ir.Literal):
        raise NotImplementedError("split pattern must be a literal")
    rx = re.compile(str(pat.value))
    col: StringColumn = v.col
    cap, out_w = col.chars.shape

    def host(n, chars_np, lens_np, valid_np):
        chars = np.zeros((cap, out_w), np.uint8)
        lens = np.zeros(cap, np.int32)
        ok = np.zeros(cap, bool)
        for i in np.flatnonzero(valid_np[:n]):
            parts = rx.split(decode(chars_np, lens_np, i))
            if 0 <= ordinal < len(parts):
                b = parts[ordinal].encode()[:out_w]
                chars[i, :len(b)] = np.frombuffer(b, np.uint8)
                lens[i] = len(b)
                ok[i] = True
        return chars, lens, ok

    chars, lens, ok = host_map(
        host, [col.chars, col.lens, v.validity], batch.num_rows,
        [(np.uint8, (out_w,)), (np.int32, ()), (np.bool_, ())],
        batch.device)
    return _string(chars, lens, ok)
