"""Model facade: one object per architecture, the entry point of the port.

Counterpart of ``repro.models.registry`` for the ported families:
``dense``; ``moe`` (whose FFN is a mixture of experts; attention, caches,
prefill, decode and verify are dense's); ``mla`` (latent attention over
one ``latent`` cache leaf: fused prefill and paging, neither prefix
sharing nor speculation); ``vlm`` (a vision stub's patches prepended by
:meth:`Model.prefill`; serving admits through the teacher-forcing loop
and pages, nothing more); ``encdec`` (Whisper: an encoder over an audio
stub's frames, a decoder with cross attention, :mod:`~repro_torch.models.
encdec`; fused admission and paging, its cross cache never paged);
``hybrid`` (RecurrentGemma: RG-LRU blocks and local attention over a
ring; dense caches and loop admission only); ``ssm`` (Mamba-2: SSD
blocks, no attention and so no kernel launch; dense caches of recurrent
state and loop admission only).  The family predicates are the
reference's.
``build_model(cfg)`` returns a :class:`Model` bound to a device: the CUDA
card unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.cache.manager import CacheManager
from repro_torch.cache.spec import CacheSpec
from repro_torch.configs.base import ModelConfig, check_ported, get_arch
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.common import init_params, logical_axes
from repro_torch.plan import LaunchPlan
from repro_torch.quant import QUANT_DTYPES

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card.  A CUDA device that is not present
    raises: nothing falls back to the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


class Model:
    """One LM of a ported family on one device: params, caches, prefill,
    decode, verify."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_params(self, seed: Union[int, torch.Generator] = 0):
        """Random weights from a seed or a generator on this device: an
        :class:`~repro_torch.models.encdec.EncDec` for the encdec family,
        an :class:`~repro_torch.models.lm.LM` otherwise."""
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        cls = encdec_mod.EncDec if self.cfg.family == "encdec" else lm_mod.LM
        return init_params(cls(self.cfg, self.device), gen)

    def param_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Every parameter's logical axes, keyed by its name in the
        weights' ``state_dict`` (:func:`~repro_torch.models.common.
        logical_axes`; the module is built on the meta device, so nothing
        is allocated).  The reference's layer stacks add a leading
        ``layers`` axis to its per-layer leaves."""
        cls = encdec_mod.EncDec if self.cfg.family == "encdec" else lm_mod.LM
        return logical_axes(cls(self.cfg, torch.device("meta")))

    def cache_axes(self, batch: int, max_len: int,
                   kv_dtype: str = "bfloat16"
                   ) -> Dict[str, Tuple[Optional[str], ...]]:
        """Every cache tensor's logical axes, keyed as
        :meth:`cache_shapes`: the reference's cache specs' axes, the layer
        stack first."""
        out = {}
        for name, (shape, _) in self.cache_shapes(batch, max_len,
                                                  kv_dtype).items():
            if name in ("k_s", "v_s"):
                axes = ("layers", "batch", "seq", "kv_heads")
            elif name == "state" and self.cfg.family == "ssm":
                axes = ("layers", "batch", "heads", "head_dim", None)
            elif name == "state":
                axes = ("layers", "batch", "state")
            elif name == "conv":
                axes = ("layers", "batch", None, "state")
            else:                 # k, v, latent, cross_k, cross_v
                axes = ("layers", "batch", "seq", "kv_heads", "head_dim")
            out[name] = axes
        return out

    def cache_shapes(self, batch: int, max_len: int,
                     kv_dtype: str = "bfloat16"
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Each dense cache tensor's (shape, dtype): K and V (layers,
        batch, max_len, Hkv, D) in ``kv_dtype`` (a KV_DTYPES name); a
        quantized ``kv_dtype`` ("int8" | "fp8") stores its storage dtype
        plus ``k_s`` / ``v_s`` f32 scales of shape (layers, batch,
        max_len, Hkv), as the reference's ``kv_cache_specs``.  An mla
        model has one ``latent`` (layers, batch, max_len, 1, kv_lora_rank
        + rope) in bfloat16 whatever ``kv_dtype`` says, as the
        reference's ``mla_cache_specs``.  An encdec model has bfloat16
        self ``k`` / ``v`` and cross ``cross_k`` / ``cross_v`` (layers,
        batch, encoder_positions, Hkv, D), whatever ``kv_dtype`` says
        (:func:`repro_torch.models.encdec.cache_shapes`).  A hybrid
        model's ``k`` / ``v`` (and scales) stack its windowed layers over
        the ring's ``min(window, max_len)`` rows, and its ``state`` /
        ``conv`` its recurrent layers
        (:func:`repro_torch.models.rglru.cache_shapes`).  An ssm model
        has only ``state`` (layers, batch, H, P, N) float32 and ``conv``
        (layers, batch, conv_width - 1, conv_dim) bfloat16
        (:func:`repro_torch.models.ssd.cache_shapes`), whatever
        ``kv_dtype`` says.  Which tensors never page:
        :meth:`unpaged_caches`."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return {name: ((cfg.num_layers,) + shape, dt)
                    for name, (shape, dt) in
                    ssd_mod.cache_shapes(cfg, batch).items()}
        if cfg.family == "mla":
            return {"latent": ((cfg.num_layers, batch, max_len, 1,
                                mla_mod.latent_width(cfg)), torch.bfloat16)}
        if cfg.family == "encdec":
            return encdec_mod.cache_shapes(cfg, batch, max_len)
        layers, rows, rec = cfg.num_layers, max_len, {}
        if cfg.family == "hybrid":
            n_rec = lm_mod.layer_kinds(cfg).count("rglru")
            layers, rows = layers - n_rec, lm_mod.ring_len(cfg, max_len)
            rec = {name: ((n_rec,) + shape, dt) for name, (shape, dt) in
                   rglru_mod.cache_shapes(cfg, batch).items()}
        shape = (layers, batch, rows, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        if kv_dtype in QUANT_DTYPES:
            dt = QUANT_DTYPES[kv_dtype].torch_dtype
            scales = {name: (shape[:4], torch.float32)
                      for name in ("k_s", "v_s")}
        else:
            dt = getattr(torch, kv_dtype)
            scales = {}
        return {"k": (shape, dt), "v": (shape, dt), **scales, **rec}

    def unpaged_caches(self) -> Tuple[str, ...]:
        """The cache tensors the paged layout keeps dense (the reference's
        ``paged=False`` leaves): encdec's cross K / V, read whole every
        step; every hybrid or ssm tensor (a ring, recurrent state), which
        the paged layout never holds anyway."""
        if self.cfg.family == "encdec":
            return encdec_mod.CROSS_LEAVES
        if self.cfg.family in ("hybrid", "ssm"):
            return tuple(self.cache_shapes(1, 1))
        return ()

    def init_cache(self, batch: int, max_len: int,
                   kv_dtype: str = "bfloat16") -> lm_mod.Caches:
        """Dense caches of :meth:`cache_shapes`, zeroed, on this device."""
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name, (shape, dt) in self.cache_shapes(
                    batch, max_len, kv_dtype).items()}

    @property
    def supports_paged_cache(self) -> bool:
        """Whether the paged layout may hold this family's caches: its
        self-attention caches are position-linear (row t holds position
        t).  The hybrid family's ring and the recurrent state of the hybrid
        and ssm families are not, so their caches stay dense."""
        return self.cfg.family in ("dense", "moe", "mla", "vlm", "encdec")

    @property
    def supports_prefix_sharing(self) -> bool:
        """Whether ``share_prefix`` may index this model's pages: paged
        caches, fused prefill (suffix prefill is its restartable form)
        and a uniform full-attention stack over the standard k/v cache,
        which excludes mla's latent cache (suffix prefill does not write
        it) and vlm (no fused prefill)."""
        return (self.supports_paged_cache and self.supports_fused_prefill
                and self.cfg.family in ("dense", "moe"))

    def cache_spec(self, batch: int, max_len: int,
                   kv_dtype: str = "bfloat16", *, layout: str = "dense",
                   page_size: int = 64, page_budget: Optional[int] = None,
                   share_prefix: bool = False,
                   prefix_capacity: Optional[int] = None) -> CacheSpec:
        """The declarative :class:`~repro_torch.cache.spec.CacheSpec` for
        this model's caches, the input a
        :class:`~repro_torch.cache.manager.CacheManager` resolves into a
        layout."""
        if layout == "paged" and not self.supports_paged_cache:
            raise ValueError(
                f"{self.cfg.family} caches are not position-linear "
                "(recurrent state / ring buffers); use layout='dense'")
        if share_prefix and not self.supports_prefix_sharing:
            raise ValueError(
                f"{self.cfg.family} models cannot share prefix pages "
                "(needs paged caches, fused prefill and a uniform "
                "full-attention stack)")
        return CacheSpec(self.cfg.family, batch, max_len, kv_dtype=kv_dtype,
                         layout=layout, page_size=page_size,
                         page_budget=page_budget, share_prefix=share_prefix,
                         prefix_capacity=prefix_capacity)

    def cache_manager(self, batch: int, max_len: int,
                      kv_dtype: str = "bfloat16", label: str = "",
                      **layout_kw) -> CacheManager:
        """Resolve :meth:`cache_spec` into a
        :class:`~repro_torch.cache.manager.CacheManager` (the owner of
        residency and page tables; the engine holds the storage).
        ``label`` names the owner in its messages (a sharded engine's
        ``shard{d}``)."""
        return CacheManager(self, self.cache_spec(batch, max_len, kv_dtype,
                                                  **layout_kw), label=label)

    def forward(self, params, batch: Dict[str, torch.Tensor], *,
                block_wrapper: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward: (logits (B, L_total, vocab) f32, the MoE
        layers' routing stats (:func:`~repro_torch.models.lm.lm_forward`;
        empty without MoE)), the reference's ``Model.forward``, whose
        auxiliary loss is the stats'
        :func:`~repro_torch.models.moe.balance_loss`.  ``batch``
        holds ``tokens`` (B, L_text) and, for a vision config,
        ``patches``, or, for an encdec config, ``frames``.
        ``block_wrapper`` wraps each repetition of a layer group's
        pattern (a remat policy); encdec takes none, as the reference's
        does.  It builds an autograd graph where the weights require
        gradients (:meth:`trainable`)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            logits = encdec_mod.encdec_forward(params, cfg, batch["tokens"],
                                               batch["frames"])
            return logits, lm_mod.no_routing(logits.device)
        return lm_mod.lm_forward(params, cfg, batch["tokens"],
                                 patches=batch.get("patches"),
                                 block_wrapper=block_wrapper)

    @staticmethod
    def trainable(params: torch.nn.Module) -> torch.nn.Module:
        """Mark every weight of ``params`` as needing a gradient, in place,
        and return it.  Weights are created frozen for serving; only the
        training path calls this, on a copy of its own."""
        for p in params.parameters():
            p.requires_grad_(True)
        return params

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                max_len: int, kv_dtype: str = "bfloat16"
                ) -> Tuple[torch.Tensor, lm_mod.Caches]:
        """Batched prefill of whole prompts in one pass: ``batch`` holds
        ``tokens`` (B, L_text) and, for a vision config, ``patches`` (B,
        P, embed_dim), prepended after ``patch_proj``, or, for an encdec
        config, ``frames`` (B, encoder_positions, d_model), encoded
        first.  Returns (the last position's logits (B, vocab) f32, dense
        caches of ``max_len`` rows laid out for :meth:`decode_step` at t
        = L_total).  As the reference's prefill emits them, encdec's
        caches and a hybrid's or an ssm model's conv tails are in the
        activation dtype."""
        cfg = self.cfg
        tokens = batch["tokens"]
        caches = self.init_cache(tokens.shape[0], max_len, kv_dtype)
        act = getattr(torch, cfg.dtype)
        for name in (tuple(caches) if cfg.family == "encdec" else
                     ("conv",) if cfg.family in ("hybrid", "ssm")
                     else ()):
            caches[name] = caches[name].to(act)
        if cfg.family == "encdec":
            logits = encdec_mod.encdec_prefill(params, cfg, tokens,
                                               batch["frames"], caches)
        else:
            logits = lm_mod.lm_prefill(params, cfg, tokens, caches,
                                       patches=batch.get("patches"),
                                       kv_dtype=kv_dtype)
        return logits, caches

    @property
    def supports_fused_prefill(self) -> bool:
        """Whether :meth:`prefill_slot_view` can consume a bucket-padded
        prompt: the token-input families (dense, moe, mla) and encdec
        (its decoder prefills tokens; the frames stay a stub).  A vision
        frontend prepends non-token positions, and the recurrent state of
        a hybrid or ssm model would fold the padding in, so vlm, hybrid
        and ssm models admit through the teacher-forcing loop."""
        if self.cfg.family == "encdec":
            return True
        return (self.cfg.family in ("dense", "moe", "mla")
                and self.cfg.frontend.kind == "none")

    @property
    def prefill_writes_full_slot(self) -> bool:
        """Whether :meth:`prefill_slot_view`'s rows cover every cache
        tensor of the slot, so that fused admission needs no slot reset.
        encdec's prefill leaves the cross cache alone, so its slots are
        reset (zeroed) at admission, as the reference's are."""
        return self.cfg.family != "encdec"

    def prefill_slot_view(self, params, tokens: torch.Tensor, length: int,
                          *, caches: Optional[lm_mod.Caches] = None,
                          slot: int = 0, plan: Optional[LaunchPlan] = None,
                          kv_dtype: str = "bfloat16"):
        """Prefill the bucket-padded prompt ``tokens`` (Lb,): (the logits
        at row ``length - 1`` (vocab,) f32, the prompt's batch-1 cache
        rows (layers, 1, Lb, ...)), written nowhere; the cache layout's
        ``write_slot`` lands them in a slot.  ``caches`` (the engine's
        storage) and ``slot`` are read only where a family's prefill
        consumes resident state: encdec's cross attention reads the
        slot's cross cache, and its rows are the self cache's alone
        (bfloat16 whatever ``kv_dtype`` says)."""
        if not self.supports_fused_prefill:
            raise NotImplementedError(
                f"{self.cfg.family} models cannot fused-prefill a padded "
                "prompt; use the loop (teacher-forcing) admission path")
        if self.cfg.family == "encdec":
            return encdec_mod.encdec_prefill_view(params, self.cfg, tokens,
                                                  length, caches, slot)
        return lm_mod.lm_prefill_view(params, self.cfg, tokens, length,
                                      plan=plan, kv_dtype=kv_dtype)

    def prefill_suffix_view(self, params: lm_mod.LM, view: lm_mod.Caches,
                            tokens: torch.Tensor, start: int, length: int,
                            *, plan: Optional[LaunchPlan] = None,
                            kv_dtype: str = "bfloat16") -> torch.Tensor:
        """Suffix-only prefill over a batch-1 cache view whose rows [0,
        start) hold a shared prefix's K/V: ``tokens`` is the bucket-padded
        unshared suffix, ``length`` the whole prompt's length.  Writes
        the suffix rows into ``view`` in place and returns the logits at
        prompt row ``length - 1``."""
        if not self.supports_prefix_sharing:
            raise NotImplementedError(
                f"{self.cfg.family} models cannot suffix-prefill a "
                "shared prefix; admit with the full prefill path")
        return lm_mod.lm_prefill_suffix_view(params, self.cfg, view, tokens,
                                             start, length, plan=plan,
                                             kv_dtype=kv_dtype)

    @property
    def supports_speculation(self) -> bool:
        """Whether the engine may run speculative verify steps against
        this model: a uniform full-attention stack over the standard k/v
        cache, whose rejected rows roll back by truncating ``kv_len``, and
        token inputs.  dense and moe qualify; mla's latent cache is not
        what the verify placement writes, and vlm has a frontend."""
        return (self.cfg.family in ("dense", "moe")
                and self.cfg.frontend.kind == "none")

    def verify_step(self, params: lm_mod.LM, caches: lm_mod.Caches,
                    tokens: torch.Tensor, t: torch.Tensor, *,
                    plan: Optional[LaunchPlan] = None) -> torch.Tensor:
        """Speculative verify: score a (B, M = k + 1)-token block per
        slot, each slot's current token and its drafts at positions [t, t
        + M), in one planned pass; caches updated in place.  Returns
        logits (B, M, vocab) f32, row ``j`` the next-token distribution
        after rows [0, j].  ``plan`` is the frozen ``("verify", k,
        bucket)`` plan."""
        if not self.supports_speculation:
            raise NotImplementedError(
                f"{self.cfg.family} models cannot run speculative verify "
                "steps (needs a uniform full-attention stack with "
                "truncation-rollbackable caches)")
        return lm_mod.lm_verify_step(params, self.cfg, caches, tokens, t,
                                     plan=plan)

    def decode_step(self, params, caches: lm_mod.Caches,
                    token: torch.Tensor, t: torch.Tensor, *,
                    plan: Optional[LaunchPlan] = None,
                    side_plans: Optional[Dict[str, LaunchPlan]] = None
                    ) -> torch.Tensor:
        """One decode step for every slot, caches updated in place;
        returns logits (B, vocab) f32.  ``plan`` is the frozen plan of the
        self-attention launches; ``side_plans`` those of the launches over
        another length (encdec's ``"cross"``, a hybrid's ``"ring"``:
        :meth:`repro_torch.serving.scheduler.Scheduler.side_plans`).
        Without them, those launches evaluate the policy inside, over
        their own length, as the reference's do."""
        if self.cfg.family == "encdec":
            return encdec_mod.encdec_decode_step(
                params, self.cfg, caches, token, t, plan=plan,
                side_plans=side_plans)
        return lm_mod.lm_decode_step(params, self.cfg, caches, token, t,
                                     plan=plan, side_plans=side_plans)

    # --- frontend stubs -----------------------------------------------------

    def frontend_inputs(self, batch: int, seq_len: int
                        ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        """Extra (non-token) inputs: name -> (shape, dtype name)."""
        cfg = self.cfg
        if cfg.frontend.kind == "vision":
            return {"patches": ((batch, cfg.frontend.num_positions,
                                 cfg.frontend.embed_dim), cfg.dtype)}
        if cfg.family == "encdec":
            return {"frames": ((batch, cfg.encoder_positions, cfg.d_model),
                               cfg.dtype)}
        return {}

    def text_len(self, seq_len: int) -> int:
        """Token count for a total sequence budget (vlm reserves patches)."""
        if self.cfg.frontend.kind == "vision":
            return max(1, seq_len - self.cfg.frontend.num_positions)
        return seq_len


def build_model(cfg_or_name: Union[ModelConfig, str],
                device: DeviceLike = None) -> Model:
    cfg = (get_arch(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    return Model(cfg, device)
