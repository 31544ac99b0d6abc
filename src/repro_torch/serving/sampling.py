"""Token sampling for the serving engine.

Counterpart of ``repro.serving.sampling``.  :class:`SamplingParams` is
the per-request knob set (temperature, top-k, top-p, seed, stop tokens,
speculation); a :class:`Sampler` turns a batch of logits into a batch of
tokens.  The engine keeps one row of sampler state per decode slot, host
arrays written at admission (:meth:`Sampler.init_state`,
:meth:`Sampler.slot_state`), and passes them with each launch's logits.

Determinism: a request's random draw at absolute position ``p`` comes
from a generator seeded by (the request's ``seed``, ``p``, a tag) alone,
through :func:`stream_seed`, on the logits' device.  So a request's
tokens do not depend on its slot or on the other requests of the batch.
A verify step's bonus row draws exactly what sequential decode would
draw at that position, and its accept coin and residual draw use tags of
their own (``0x5EC``, ``0x5ED``), as the reference folds them into its
key.  The streams differ from the reference's: JAX's PRNG is not
PyTorch's, so sampled tokens differ across the two packages (and across
devices, whose generators differ).

``temperature == 0`` rows are exact ``torch.argmax``, bit for bit what
:class:`GreedySampler` gives; a batch with no sampled row sorts nothing
and draws nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch.spec import SpecConfig

# sampler state: one host row per decode slot
SamplerState = Dict[str, np.ndarray]

ACCEPT_TAG = 0x5EC     # the accept coin of a verify row
RESIDUAL_TAG = 0x5ED   # the residual draw of a rejected verify row
_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.  ``temperature == 0`` is greedy;
    ``top_k == 0`` and ``top_p == 1.0`` disable the truncations.  ``stop``
    tokens end the request with ``finish_reason="stop"`` (the stop token
    itself is emitted).  ``speculation`` opts the request into
    speculative decoding (a :class:`~repro_torch.spec.SpecConfig`,
    validated at submit); ``None`` is plain decode."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop: Tuple[int, ...] = ()
    speculation: Optional[SpecConfig] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.speculation is not None and \
                not isinstance(self.speculation, SpecConfig):
            raise TypeError(
                "SamplingParams.speculation must be a repro_torch.spec."
                f"SpecConfig or None, got {type(self.speculation).__name__}")


GREEDY = SamplingParams()


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, pos: int, tag: Optional[int] = None) -> int:
    """The 64-bit generator seed of one draw: a hash of the request's
    ``seed``, the absolute position ``pos`` and an optional ``tag``, so
    each (seed, position, tag) has a stream of its own."""
    h = _splitmix64(_splitmix64(int(seed) & _MASK64) ^ (int(pos) & _MASK64))
    if tag is not None:
        h = _splitmix64(h ^ _splitmix64(int(tag) & _MASK64))
    return h


def _generator(device: torch.device, seed: int, pos: int,
               tag: Optional[int] = None) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, pos, tag))
    return g


def _uniforms(device: torch.device, draws: Sequence[Tuple[int, int,
                                                           Optional[int]]],
              n: int) -> torch.Tensor:
    """(len(draws), n) f32 uniforms in [tiny, 1): row r from the stream
    of ``draws[r]`` = (seed, pos, tag)."""
    rows = [torch.rand(n, generator=_generator(device, *d), device=device)
            for d in draws]
    return torch.stack(rows).clamp_(min=torch.finfo(torch.float32).tiny)


def _categorical(scaled: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw over the last dim of f32 ``scaled`` (-inf entries
    are never drawn) with uniforms ``u`` of the same shape."""
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)


def _mask_top_k(scaled: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Keep each row's k largest logits (k == 0 disables).  Ties at the
    threshold are kept, per the usual top-k convention."""
    V = scaled.shape[-1]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k <= 0, V, top_k).clamp(1, V).long()
    thresh = desc.gather(-1, (k - 1)[:, None])
    return torch.where(scaled < thresh, -torch.inf, scaled)


def _mask_top_p(scaled: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus truncation: keep the smallest prefix of the probability-
    sorted vocab whose mass reaches ``top_p`` (the argmax is always
    kept; a value tied with the last kept one is kept too)."""
    desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]        # mass BEFORE this token
    kept = torch.where(keep, desc, torch.inf)
    thresh = kept.amin(dim=-1, keepdim=True)
    return torch.where(scaled < thresh, -torch.inf, scaled)


def _accepted_prefix(accept_rows: torch.Tensor) -> torch.Tensor:
    """(B, M-1) per-row accept bools -> (B,) longest accepted prefix."""
    return torch.cumprod(accept_rows.long(), dim=1).sum(dim=1)


class Sampler:
    """Base sampler: per-slot state rows, ``sample`` and ``verify``.

    ``slot_state(params)`` gives the scalars the engine writes into row
    ``i`` of its state arrays at admission; ``sample(logits, state,
    pos)`` and ``verify(logits, draft, state, pos)`` run after each
    launch on the logits' device.  ``state`` and ``pos`` are host arrays
    over the launch's rows.  Subclass (and :func:`register_sampler`) to
    plug in new strategies.
    """

    #: state-array layout: name -> (trailing shape, dtype)
    STATE_SPEC = {
        "temperature": ((), np.float32),
        "top_k": ((), np.int32),
        "top_p": ((), np.float32),
        "seed": ((), np.int64),
    }

    def init_state(self, batch_slots: int) -> SamplerState:
        """Host-side per-slot state arrays (one row per decode slot)."""
        state = {name: np.zeros((batch_slots,) + shape, dtype)
                 for name, (shape, dtype) in self.STATE_SPEC.items()}
        state["top_p"][:] = 1.0
        return state

    def slot_state(self, sp: SamplingParams) -> Dict[str, np.generic]:
        """One request's state row, written at slot admission."""
        return {
            "temperature": np.float32(sp.temperature),
            "top_k": np.int32(sp.top_k),
            "top_p": np.float32(sp.top_p),
            "seed": np.int64(sp.seed),
        }

    def check(self, sp: SamplingParams) -> None:
        """Reject params this sampler would silently ignore (called at
        ``ServingEngine.submit`` so the mismatch fails fast)."""

    def sample(self, logits: torch.Tensor, state: SamplerState,
               pos) -> torch.Tensor:
        """logits (B, V), state rows (B, ...), pos (B,) -> tokens (B,)
        int64 on the logits' device.  ``pos`` is the absolute position of
        the row each logit row was computed from."""
        raise NotImplementedError

    def verify(self, logits: torch.Tensor, draft: torch.Tensor,
               state: SamplerState, pos
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched speculative accept/reject.

        ``logits``: (B, M, V) teacher-forced verify scores; row ``j`` is
        the distribution of the token at absolute position ``pos + j +
        1``.  ``draft``: (B, M - 1) proposed tokens for rows 0..M-2 (row
        M-1 is the bonus row when everything accepts); a negative entry
        is padding (a slot with fewer drafts than the launch's k): its
        row accepts nothing and its token is drawn as at a plain decode
        position, so a slot whose every draft verified gets the token
        sequential decode would draw after them.  ``pos``: (B,) absolute
        position of each slot's first fed row.

        Returns ``(tokens (B, M) int64, accepted (B,) int64)``:
        ``accepted`` is the longest accepted draft prefix and ``tokens[b,
        accepted[b]]`` the correction or bonus token emitted after the
        accepted drafts.  The engine also clamps ``accepted`` by each
        slot's true draft length.
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not implement speculative "
            "verify; use GreedySampler or CategoricalSampler for "
            "requests with SamplingParams.speculation")


class GreedySampler(Sampler):
    """Argmax (ties go to the lowest index, as ``jnp.argmax`` does): no
    vocab sort, no draw.  Rejects requests that ask for sampling."""

    def sample(self, logits: torch.Tensor, state: SamplerState,
               pos) -> torch.Tensor:
        return torch.argmax(logits, dim=-1)

    def verify(self, logits: torch.Tensor, draft: torch.Tensor,
               state: SamplerState, pos
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Longest accepted prefix: row j accepts iff its draft equals
        the teacher-forced argmax, so the emitted stream is sequential
        greedy decode's by construction."""
        greedy = torch.argmax(logits, dim=-1)                    # (B, M)
        return greedy, _accepted_prefix(greedy[:, :-1] == draft)

    def check(self, sp: SamplingParams) -> None:
        if sp.temperature > 0 or sp.top_k > 0 or sp.top_p < 1.0:
            raise ValueError(
                "GreedySampler ignores temperature/top_k/top_p; use "
                "CategoricalSampler (the ServingEngine default) for "
                f"sampled requests, got {sp}")


class CategoricalSampler(Sampler):
    """Temperature, top-k and top-p sampling; greedy where temperature
    is 0.  The truncations compose (k, then p, both over the
    temperature-scaled logits)."""

    @staticmethod
    def _scaled(logits: torch.Tensor, state: SamplerState,
                rows: np.ndarray) -> torch.Tensor:
        """The sampled ``rows``' logits (R, ..., V) scaled by their
        temperatures and masked by their top-k, then top-p, in f32."""
        dev = logits.device
        sub = logits[torch.as_tensor(rows, device=dev)].float()
        temp = torch.as_tensor(state["temperature"][rows], device=dev)
        lead = sub.shape[1:-1]
        scaled = sub / temp.clamp(min=1e-6).reshape((-1,) + (1,) * (
            sub.dim() - 1))
        reps = int(np.prod(lead, dtype=np.int64))
        flat = scaled.reshape(-1, sub.shape[-1])
        flat = _mask_top_k(flat, torch.as_tensor(
            np.repeat(state["top_k"][rows], reps), device=dev))
        flat = _mask_top_p(flat, torch.as_tensor(
            np.repeat(state["top_p"][rows], reps), device=dev))
        return flat.reshape(scaled.shape)

    def sample(self, logits: torch.Tensor, state: SamplerState,
               pos) -> torch.Tensor:
        greedy = torch.argmax(logits, dim=-1)
        rows = np.flatnonzero(state["temperature"] > 0)
        if rows.size == 0:
            return greedy
        pos = np.asarray(pos)
        scaled = self._scaled(logits, state, rows)               # (R, V)
        u = _uniforms(logits.device, [(state["seed"][b], pos[b], None)
                                      for b in rows], scaled.shape[-1])
        out = greedy.clone()
        out[torch.as_tensor(rows, device=logits.device)] = \
            _categorical(scaled, u)
        return out

    def verify(self, logits: torch.Tensor, draft: torch.Tensor,
               state: SamplerState, pos
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rejection sampling against the teacher-forced target.

        The drafters propose deterministically (a point-mass draft), so
        the rule is: accept draft ``d`` at row ``j`` with probability
        ``p_j(d)`` (the masked, temperature-scaled target probability);
        on rejection, draw from the residual, ``p_j`` with ``d`` removed
        and renormalised, which keeps every emitted token distributed as
        the target.  Row ``j``'s draws use position ``pos + j``: the
        bonus row's (and a padding row's) is the stream ``sample`` uses
        there, the coin and the residual carry their own tags.  Greedy
        rows take the exact argmax-prefix rule.
        """
        B, M, V = logits.shape
        greedy = torch.argmax(logits, dim=-1)                    # (B, M)
        tokens = greedy.clone()
        accept = greedy[:, :-1] == draft                         # (B, M-1)
        rows = np.flatnonzero(state["temperature"] > 0)
        if rows.size:
            dev = logits.device
            pos = np.asarray(pos)
            ridx = torch.as_tensor(rows, device=dev)
            scaled = self._scaled(logits, state, rows)           # (R, M, V)
            d = draft[ridx]                                      # (R, M-1)
            real = d >= 0
            dc = d.clamp(min=0)[..., None]
            probs = torch.softmax(scaled[:, :M - 1], dim=-1)
            p_draft = probs.gather(-1, dc)[..., 0]
            seeds = [(state["seed"][b], pos[b]) for b in rows]
            coin = _uniforms(dev, [(s, p + j, ACCEPT_TAG)
                                   for s, p in seeds for j in range(M - 1)],
                             1).reshape(len(rows), M - 1)
            resid = torch.where(
                real[..., None],
                scaled[:, :M - 1].scatter(-1, dc, -torch.inf),
                scaled[:, :M - 1])
            real_host = real.cpu().numpy()
            u = _uniforms(dev, [(s, p + j, RESIDUAL_TAG
                                 if j < M - 1 and real_host[r, j] else None)
                                for r, (s, p) in enumerate(seeds)
                                for j in range(M)], V)
            drawn = _categorical(torch.cat([resid, scaled[:, M - 1:]], 1),
                                 u.reshape(len(rows), M, V))
            tokens[ridx] = drawn
            accept[ridx] = (coin < p_draft) & real
        return tokens, _accepted_prefix(accept)


_SAMPLERS: Dict[str, Type[Sampler]] = {}


def register_sampler(name: str, cls: Type[Sampler]) -> None:
    _SAMPLERS[name] = cls


def get_sampler(name: str) -> Sampler:
    """Sampler registry: ``greedy`` | ``categorical`` (aliases
    ``temperature`` / ``top_k`` / ``top_p``: the knobs live in
    :class:`SamplingParams`, the math in one sampler)."""
    try:
        return _SAMPLERS[name]()
    except KeyError:
        raise ValueError(f"unknown sampler {name!r}; "
                         f"known: {sorted(_SAMPLERS)}") from None


register_sampler("greedy", GreedySampler)
register_sampler("categorical", CategoricalSampler)
register_sampler("temperature", CategoricalSampler)
register_sampler("top_k", CategoricalSampler)
register_sampler("top_p", CategoricalSampler)
