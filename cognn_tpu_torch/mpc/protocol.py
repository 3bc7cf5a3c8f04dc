"""Secret-shared fixed-point tensor protocol on int64 shares (port of
``cognn_tpu/mpc/protocol.py``).

A share tensor is ``int64[2, *dims]``: axis 0 is the share, and one int64 is
one element of Z_2^64 (the JAX package's uint32 limb axis is gone). LINEAR
ops (add, masked add, aggregation, halo shipping) act sharewise and never
reconstruct. Multiplicative ops reconstruct, compute exactly mod 2^64
(:func:`cognn_tpu_torch.ops.intmatmul.ring_matmul` for matmuls), truncate and
re-share with fresh randomness: the values are those of the reference's
Beaver-triple 2PC with faithful truncation. Nonlinear ops (the ReLU sign,
softmax) reconstruct and mask, as in the JAX package.

Where the JAX package takes a ``jax.random`` key, these methods take a
``torch.Generator`` (on the tensors' device) that the caller owns. Under
``truncation="exact"`` every reconstructed value is independent of the
random words, so the port's values equal the JAX package's bit for bit.
``truncation="probabilistic"`` shifts the shares locally (SecureML-style),
with the known off-by-one or wrap error of probability ~|x|/2^(64-f).

The JAX package's ``matmul_path`` ("small" / "full") is not ported: it chose
between two MXU dot counts, and the port's kernel is exact for any 64-bit
operands.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
from cognn_tpu_torch.core.ring import (
    ring_add,
    ring_arith_shift_right,
    ring_from_f32,
    ring_mul,
    ring_neg,
    ring_sub,
    ring_to_f32,
)
from cognn_tpu_torch.core.shares import share_split
from cognn_tpu_torch.ops.intmatmul import ring_matmul

_LOW63 = (1 << 63) - 1


@dataclasses.dataclass
class Protocol:
    """Stateless op collection bound to a fixed-point spec."""

    fp: FixedPointSpec = dataclasses.field(default_factory=FixedPointSpec)
    truncation: str = "exact"  # "exact" | "probabilistic"
    # Sign extraction: "reconstruct" forms x = a + b and reads its sign;
    # "bitdecomp" never forms x and takes the MSB of a + b from the carry
    # into bit 63 of the two shares (the share-space analogue of the
    # reference's 2PC comparison, `optimize-gcn/gcn.h:549`).
    nonlinear: str = "reconstruct"  # "reconstruct" | "bitdecomp"

    def __post_init__(self):
        if self.truncation not in ("exact", "probabilistic"):
            raise ValueError(f"truncation {self.truncation!r}")
        if self.nonlinear not in ("reconstruct", "bitdecomp"):
            raise ValueError(f"nonlinear {self.nonlinear!r}")

    @property
    def f(self) -> int:
        return self.fp.frac_bits

    # -- share creation / reconstruction ---------------------------------
    def share(self, gen: torch.Generator, x_f32: torch.Tensor) -> torch.Tensor:
        """float32 -> int64[2, ...] share tensor."""
        return share_split(gen, ring_from_f32(x_f32, self.f))

    def reshare(self, gen: torch.Generator,
                ring_val: torch.Tensor) -> torch.Tensor:
        return share_split(gen, ring_val)

    def reconstruct_ring(self, sh: torch.Tensor) -> torch.Tensor:
        return ring_add(sh[0], sh[1])

    def reveal(self, sh: torch.Tensor) -> torch.Tensor:
        """-> float32 plaintext (sci::getPlainShareVecVec equivalent)."""
        return ring_to_f32(self.reconstruct_ring(sh), self.f)

    # -- linear ops (sharewise; never reconstruct) -----------------------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return ring_add(a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return ring_sub(a, b)

    def zeros(self, shape, *, device) -> torch.Tensor:
        return torch.zeros((2, *shape), dtype=torch.int64, device=device)

    def mask_mul(self, sh: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Multiply by a public 0/1 mask (broadcast over the share axis) —
        the conditional in twoPartyGCNCondVectorAddition (gcn.h:456-463)."""
        return sh * mask.to(torch.int64)[None]

    # -- truncation ------------------------------------------------------
    def _trunc_ring(self, gen: torch.Generator, val: torch.Tensor,
                    shift: int) -> torch.Tensor:
        return self.reshare(gen, ring_arith_shift_right(val, shift))

    def trunc(self, gen: torch.Generator, sh: torch.Tensor,
              shift: int | None = None) -> torch.Tensor:
        shift = self.f if shift is None else shift
        if self.truncation == "probabilistic":
            s0 = ring_arith_shift_right(sh[0], shift)
            s1 = ring_neg(ring_arith_shift_right(ring_neg(sh[1]), shift))
            return torch.stack([s0, s1])
        return self._trunc_ring(gen, self.reconstruct_ring(sh), shift)

    # -- multiplicative ops ----------------------------------------------
    def matmul(self, gen: torch.Generator, a_sh: torch.Tensor,
               b_sh: torch.Tensor) -> torch.Tensor:
        """Shared [B, N, K] @ shared [B, K, M] -> shared [B, N, M] at the
        f-bit scale, one kernel launch for the whole batch (the parties;
        sci::twoPartyGCNMatMul equivalent)."""
        return self.matmul_prepped(gen, self.prep_matmul_a(a_sh), b_sh)

    def prep_matmul_a(self, a_sh: torch.Tensor) -> torch.Tensor:
        """The A side of :meth:`matmul` for a loop-invariant shared operand
        (the feature matrix x0 in the layer-0 matmul, `optimize-gcn/
        gcn.h:233`): its reconstruct, done once."""
        return self.reconstruct_ring(a_sh)

    def matmul_prepped(self, gen: torch.Generator, prep_a: torch.Tensor,
                       b_sh: torch.Tensor) -> torch.Tensor:
        """:meth:`matmul` with the A side from :meth:`prep_matmul_a`."""
        prod = ring_matmul(prep_a, self.reconstruct_ring(b_sh))  # 2f scale
        return self._trunc_ring(gen, prod, self.f)

    def scale_rows(self, gen: torch.Generator, sh: torch.Tensor,
                   scalars_fp: torch.Tensor) -> torch.Tensor:
        """Multiply by public fixed-point scalars broadcast against the
        value dims (sci::twoPartyGCNVectorScale equivalent)."""
        return self.trunc(gen, ring_mul(sh, scalars_fp[None]))

    def scale_const(self, gen: torch.Generator, sh: torch.Tensor,
                    c: float) -> torch.Tensor:
        """Multiply by a public float constant via its fixed-point encoding
        (sci::twoPartyGCNMatrixScale: c encoded as int64(trunc(c * 2^f)))."""
        enc = int(np.int64(np.trunc(c * self.fp.scale)))
        return self.trunc(gen, ring_mul(sh, enc))

    # -- nonlinear ops (reconstruct-and-mask) ----------------------------
    def sign_mask(self, sh: torch.Tensor) -> torch.Tensor:
        """Public bool mask of (x > 0); mode per ``nonlinear``."""
        if self.nonlinear == "bitdecomp":
            return self._sign_mask_bitdecomp(sh)
        return self.reconstruct_ring(sh) > 0

    def _sign_mask_bitdecomp(self, sh: torch.Tensor) -> torch.Tensor:
        """(x > 0) without forming x = a + b: the MSB of the sum is
        msb(a) XOR msb(b) XOR the carry into bit 63, and that carry is bit 63
        of (a mod 2^63) + (b mod 2^63), read as bit 62 of their halved sum
        so nothing overflows. The zero test is a == -b, also share-local."""
        a, b = sh[0], sh[1]
        la, lb = a & _LOW63, b & _LOW63
        half = (la >> 1) + (lb >> 1) + (la & lb & 1)
        carry = ((half >> 62) & 1).bool()
        msb = (a < 0) ^ (b < 0) ^ carry
        return ~msb & (a != ring_neg(b))

    def relu(self, sh: torch.Tensor) -> torch.Tensor:
        """x * (x > 0) — mask multiply keeps shares linear, no truncation
        (sci::twoPartyGCNRelu equivalent)."""
        return self.mask_mul(sh, self.sign_mask(sh))

    # -- comparison / MIN family -------------------------------------------
    def less_mask(self, a_sh: torch.Tensor,
                  b_sh: torch.Tensor) -> torch.Tensor:
        """Public bool mask of (a < b): sign test on b - a."""
        return self.sign_mask(self.sub(b_sh, a_sh))

    def select(self, mask: torch.Tensor, a_sh: torch.Tensor,
               b_sh: torch.Tensor) -> torch.Tensor:
        """Elementwise ``mask ? a : b`` on shares (linear: one operand
        survives per element)."""
        return torch.where(mask[None], a_sh, b_sh)

    def minimum(self, a_sh: torch.Tensor, b_sh: torch.Tensor) -> torch.Tensor:
        """Shared elementwise min — the MIN combine of the analytics family
        (bfs/cc/sssp)."""
        return self.select(self.less_mask(a_sh, b_sh), a_sh, b_sh)

    def add_public(self, sh: torch.Tensor,
                   pub_ring: torch.Tensor) -> torch.Tensor:
        """Add a public ring value (broadcastable) to share 0 only, the
        standard additive-sharing form of a public constant."""
        return torch.cat([ring_add(sh[0], pub_ring)[None], sh[1:]])

    def softmax_pred(self, gen: torch.Generator, z_sh: torch.Tensor,
                     y_onehot: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prob_f32, shares of p - y) — the prediction Apply
        (sci::twoPartyGCNForwardNNPredictionWithoutWeight)."""
        prob = torch.softmax(self.reveal(z_sh), dim=-1)
        return prob, self.share(gen, prob - y_onehot.to(prob.dtype))

    # -- fixed-point encode helpers --------------------------------------
    def encode_public(self, x_f32: torch.Tensor) -> torch.Tensor:
        """float -> public ring fixed-point (for normalizer vectors)."""
        return ring_from_f32(x_f32, self.f)
