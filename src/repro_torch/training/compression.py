"""Gradient compression: int8 quantization with error feedback (EF-SGD).

Counterpart of ``repro.training.compression``, for the data-parallel
gradient exchange: the replicas quantize their gradients to int8 against
one shared scale (the largest magnitude over every replica, / 127), sum
the codes in int32 (no overflow below 2^23 replicas), and dequantize the
sum.  Each replica keeps its quantization residual in an error-feedback
buffer and adds it to its next gradient, which restores convergence
(EF-SGD, Karimireddy et al.).

The reference runs :func:`compressed_psum` inside a ``shard_map`` over
the data axis, with ``pmax`` / ``psum`` as the exchange; here the
replicas' gradients are a list, one dict of tensors a replica (each on
its device), and the exchange moves the replicas' maxima and int8 codes
to the first replica's device.  :func:`build_compressed_dp_grads` is the
data-parallel gradient function: the weights replicated, the batch cut
over the grid's data rows, each row's gradient computed on its device.
``TrainConfig.grad_compression`` names this scheme, as the reference's
does; neither package's train step reads it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple, Union

import torch

Grads = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 codes of ``x`` against ``scale`` (float32): round
    half to even, clipped to [-127, 127], as the reference's."""
    q = torch.round(x.float() / torch.clamp(scale, min=1e-30))
    return torch.clamp(q, -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _residual(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``x - q * scale`` rounded once to float32: the reference's
    ``gf - dequantize_int8(q, scale)``, which XLA computes as one fused
    multiply-subtract.  In float64 the product is exact (8 by 24 bits)
    and so is the difference of two numbers this close, so the one
    rounding is the cast."""
    return (x.double() - q.double() * scale.double()).float()


def init_error_feedback(params: Mapping[str, torch.Tensor]) -> Grads:
    """Zero float32 error-feedback buffers beside every weight."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def compressed_psum(grads: Sequence[Mapping[str, torch.Tensor]], *,
                    ef: Sequence[Mapping[str, torch.Tensor]]
                    ) -> Tuple[Grads, List[Grads]]:
    """The mean of the replicas' ``grads`` (one dict a replica) with int8
    error-feedback compression: (the mean, float32, on the first
    replica's device; each replica's new error-feedback buffers, on its
    device).  Leaf by leaf: every replica adds its buffer to its
    gradient in float32, the shared scale is the largest magnitude over
    the replicas / 127, each replica's int8 codes are summed in int32 and
    dequantized, then divided by the replica count; each replica's
    residual (its float32 gradient less its dequantized codes, rounded
    once: :func:`_residual`) is its new buffer."""
    n = len(grads)
    lead = next(iter(grads[0].values())).device
    mean: Grads = {}
    new_ef: List[Grads] = [{} for _ in range(n)]
    for name in grads[0]:
        gf = [g[name].float() + e[name] for g, e in zip(grads, ef)]
        m = torch.stack([torch.max(torch.abs(x)).to(lead) for x in gf]).max()
        scale = m / 127.0
        total = None
        for i, x in enumerate(gf):
            s = scale.to(x.device)
            q = quantize_int8(x, s)
            new_ef[i][name] = _residual(x, q, s)
            q = q.to(lead).to(torch.int32)
            total = q if total is None else total + q
        mean[name] = dequantize_int8(total, scale) / n
    return mean, new_ef


def build_compressed_dp_grads(loss_fn: Callable, mesh, *,
                              data_axis: str = "data") -> Callable:
    """-> ``grad_fn(params, batch, ef) -> (loss, grads, new_ef)``: the
    data-parallel gradient of ``loss_fn(params, batch) -> (loss, aux)``
    over ``mesh``'s ``data_axis`` (its rows), exchanged
    through :func:`compressed_psum`.  ``params`` (a dict of tensors) are
    replicated: each replica reads them on its device, where it computes
    the gradient of its equal cut of the batch (along dim 0).  ``ef`` is
    one dict of buffers, which every replica starts from (the
    reference's replicated input), or a list of one dict a replica; the
    new buffers come back as such a list.  ``loss`` is the replicas'
    mean, ``grads`` their compressed mean, on the first replica's
    device."""
    if data_axis != "data":
        raise ValueError(f"the replicas are a grid's data rows, not its "
                         f"{data_axis!r} axis")
    devices = [row[0] for row in mesh.rows]

    def grad_fn(params: Mapping[str, torch.Tensor],
                batch: Mapping[str, torch.Tensor],
                ef: Union[Mapping, Sequence[Mapping]]):
        n = len(devices)
        efs = list(ef) if isinstance(ef, (list, tuple)) else [ef] * n
        B = next(iter(batch.values())).shape[0]
        if B % n:
            raise ValueError(f"a batch of {B} does not cut over {n} "
                             "replicas")
        b = B // n
        names = list(params)
        losses, grads = [], []
        for i, dev in enumerate(devices):
            local = {k: v.detach().to(dev).requires_grad_(True)
                     for k, v in params.items()}
            part = {k: v[i * b:(i + 1) * b].to(dev)
                    for k, v in batch.items()}
            loss, _ = loss_fn(local, part)
            g = torch.autograd.grad(loss, [local[k] for k in names])
            losses.append(loss.detach().to(devices[0]))
            grads.append(dict(zip(names, g)))
        efs = [{k: e[k].to(dev) for k in names}
               for e, dev in zip(efs, devices)]
        mean, new_ef = compressed_psum(grads, ef=efs)
        return torch.stack(losses).mean(), mean, new_ef

    return grad_fn
