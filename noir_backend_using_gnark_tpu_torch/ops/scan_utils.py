"""Log-depth scans along the last axis over an associative combine.

Counterpart of ``noir_backend_using_gnark_tpu/ops/scan_utils.py``. The
combine is a field or group operation built on kernel K3, so each level
of a scan is a handful of launches over the whole level; nothing loops
over n in Python.

An element is a tensor or a tuple of tensors whose last axes have the
same length (a tuple carries e.g. the (p, a) pairs of an affine map).
"""

from __future__ import annotations

from typing import Callable

import torch


def _map(fn, elems):
    return tuple(fn(e) for e in elems) if isinstance(elems, tuple) else fn(elems)


def _zip_map(fn, *trees):
    if isinstance(trees[0], tuple):
        return tuple(fn(*xs) for xs in zip(*trees))
    return fn(*trees)


def _length(elems) -> int:
    return (elems[0] if isinstance(elems, tuple) else elems).shape[-1]


def _slice(elems, sl):
    return _map(lambda a: a[..., sl], elems)


def _cat(*trees):
    return _zip_map(lambda *xs: torch.cat(xs, dim=-1), *trees)


def inclusive_scan(combine: Callable, elems):
    """Inclusive scan along the last axis: out[i] = e[0] o ... o e[i].

    Work-efficient recursion (about 2n combines over log2 n levels):
    pair up neighbours, scan the pair sums, then fill in the even slots.
    """
    n = _length(elems)
    if n == 1:
        return elems
    m = n // 2
    even = _slice(elems, slice(0, 2 * m, 2))
    odd = _slice(elems, slice(1, 2 * m, 2))
    scanned_pairs = inclusive_scan(combine, combine(even, odd))  # odd slots
    first = _slice(even, slice(0, 1))
    if m > 1:
        rest = combine(_slice(scanned_pairs, slice(0, m - 1)), _slice(even, slice(1, m)))
        even_out = _cat(first, rest)
    else:
        even_out = first

    def interleave(e, o):
        return torch.stack([e, o], dim=-1).reshape(e.shape[:-1] + (2 * e.shape[-1],))

    out = _zip_map(interleave, even_out, scanned_pairs)
    if n % 2:
        tail = combine(_slice(scanned_pairs, slice(m - 1, m)), _slice(elems, slice(n - 1, n)))
        out = _cat(out, tail)
    return out


def rolled_scan(combine: Callable, elems):
    """Inclusive scan along the last axis by Hillis-Steele doubling:
    ceil(log2 n) steps, each one combine over the whole axis (n log n
    work, the JAX package's ``rolled_scan``). Lanes without a left
    neighbour at distance d keep their value."""
    n = _length(elems)
    d = 1
    while d < n:
        shifted = _map(lambda a: a[..., : n - d], elems)
        right = _map(lambda a: a[..., d:], elems)
        combined = combine(shifted, right)
        elems = _cat(_slice(elems, slice(0, d)), combined)
        d *= 2
    return elems
