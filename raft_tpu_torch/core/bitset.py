"""Packed bitset — the backbone of filtered search.

Counterpart of ``raft_tpu/core/bitset.py``. Bits are packed 32 to a word;
the words are held as ``int32`` tensors carrying the same bit pattern as
the reference's ``uint32`` words (PyTorch's bitwise and shift operators do
not cover ``uint32``), and convert losslessly through numpy views.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.resources import resolve_device

WORD_BITS = 32


def _as_words(bits) -> torch.Tensor:
    """uint32 words (numpy or tensor) as the int32 tensor of the same bits."""
    if isinstance(bits, torch.Tensor):
        if bits.dtype == torch.int32:
            return bits
        return torch.from_numpy(
            bits.cpu().numpy().astype(np.uint32).view(np.int32)
        ).to(bits.device)
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(bits).astype(np.uint32)).view(np.int32))


def _fill(default: bool) -> int:
    return -1 if default else 0


class Bitset:
    """A bitset over ``n_bits`` items packed into 32-bit words."""

    def __init__(self, n_bits: int, bits=None, default: bool = True,
                 device=None):
        self.n_bits = int(n_bits)
        # bumped by every in-place mutator so caches keyed on the wrapper
        # can detect content changes
        self._version = 0
        n_words = (self.n_bits + WORD_BITS - 1) // WORD_BITS
        if bits is not None:
            words = _as_words(bits)
            if tuple(words.shape) != (n_words,):
                raise ValueError(
                    f"bitset of {self.n_bits} bits needs {n_words} words, "
                    f"got shape {tuple(words.shape)}")
            self.bits = words.to(device) if device is not None else words
        else:
            self.bits = torch.full((n_words,), _fill(default),
                                   dtype=torch.int32,
                                   device=resolve_device(device))

    @staticmethod
    def test_bits(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Bool tensor, True where the bit at ``idx`` is set."""
        idx = idx.long()
        word = bits[idx // WORD_BITS]
        return ((word >> (idx % WORD_BITS).to(torch.int32)) & 1).bool()

    def test(self, idx) -> torch.Tensor:
        return Bitset.test_bits(
            self.bits, torch.as_tensor(idx, device=self.bits.device))

    def set(self, idx, value: bool = True) -> "Bitset":
        idx = torch.as_tensor(idx, device=self.bits.device).long().reshape(-1)
        dense = self.to_dense()
        dense[idx] = bool(value)
        self.bits = Bitset.from_dense(dense).bits
        self._version += 1
        return self

    def flip(self) -> "Bitset":
        self.bits = ~self.bits
        self._version += 1
        return self

    @staticmethod
    def count_bits(bits: torch.Tensor, n_bits: int) -> torch.Tensor:
        """Set-bit count over raw words, ignoring bits past ``n_bits``."""
        pos = torch.arange(bits.shape[0] * WORD_BITS, device=bits.device)
        words = bits.repeat_interleave(WORD_BITS)
        on = ((words >> (pos % WORD_BITS).to(torch.int32)) & 1).bool()
        return (on & (pos < n_bits)).sum()

    def count(self) -> torch.Tensor:
        return Bitset.count_bits(self.bits, self.n_bits)

    def copy(self) -> "Bitset":
        out = Bitset(self.n_bits, bits=self.bits.clone())
        return out

    def resize(self, n_bits: int, default: bool = True) -> "Bitset":
        """Grow (or shrink) to ``n_bits`` in place; new bits get
        ``default``. Returns ``self``."""
        n_bits = int(n_bits)
        old_n = self.n_bits
        if n_bits == old_n:
            return self
        fill = _fill(default)
        n_words = (n_bits + WORD_BITS - 1) // WORD_BITS
        bits = self.bits.clone()
        if n_bits > old_n:
            tail = old_n % WORD_BITS
            if tail:
                # bits [tail, 32) of the old last word are undefined: force
                # them to `default`, word for word as the reference does
                li = old_n // WORD_BITS
                mask = (1 << tail) - 1
                bits[li] = (bits[li] & mask) | (fill & ~mask)
            if n_words > bits.shape[0]:
                bits = torch.cat([bits, torch.full(
                    (n_words - bits.shape[0],), fill, dtype=torch.int32,
                    device=bits.device)])
        else:
            bits = bits[:n_words]
        self.bits = bits
        self.n_bits = n_bits
        self._version += 1
        return self

    def to_dense(self) -> torch.Tensor:
        """Bool vector of length n_bits."""
        return Bitset.test_bits(
            self.bits, torch.arange(self.n_bits, device=self.bits.device))

    def to_numpy(self) -> np.ndarray:
        """The words as the reference's uint32 array."""
        return self.bits.cpu().numpy().view(np.uint32)

    @staticmethod
    def from_dense(mask) -> "Bitset":
        mask = torch.as_tensor(mask).bool().reshape(-1)
        n = mask.shape[0]
        pad = (-n) % WORD_BITS
        m = torch.cat([mask, mask.new_zeros(pad)]).reshape(-1, WORD_BITS)
        weights = torch.ones(WORD_BITS, dtype=torch.int64,
                             device=mask.device) << torch.arange(
                                 WORD_BITS, device=mask.device)
        words = (m.long() * weights).sum(dim=1)
        # fold the u32 value into the int32 bit pattern
        words = torch.where(words >= 2**31, words - 2**32, words)
        return Bitset(n, bits=words.to(torch.int32))
