"""Operation counts of the port's programs, as they execute (the
counterpart of ``scripts/flops.py``'s XLA cost analysis).

``count(fn)`` runs fn once and returns its floating-point operations: the
aten ops ``torch.utils.flop_counter.FlopCounterMode`` counts (matrix
products and convolutions, 2 m k n for an m x k by k x n product; the
elementwise work is not counted) plus what the kernels launched in the
call added to their ``flops.*`` counters (``ops/work.py``,
``utils/trace.py``; the mode cannot see a ctypes launch). On the CPU the
kernels' plain versions run as aten ops and the mode counts them; each
counter counts its kernel's products as that plain version computes them,
so a stage counts alike on both devices.

XLA counts a ``lax.scan`` body once (a 50-step scan of a 64^3 matmul
reads 2 x 64^3 + 2), so the JAX package's count of its 50-step sampler
holds the denoiser once; ``generate_parts`` counts the sampler as it runs:
its steps times the step.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from mld_tpu_torch.utils import trace


def count(fn: Callable, grad: bool = False) -> int:
    """Operations of one call of fn (aten ops and the kernels it
    launched), under no_grad unless `grad` (a training step's backward)."""
    before = trace.total("flops")
    with torch.set_grad_enabled(grad), \
            FlopCounterMode(display=False) as mode:
        fn()
    return int(mode.get_total_flops()) + trace.total("flops") - before


def generate_parts(mld, token_ids: torch.Tensor, mask: torch.Tensor,
                   generator: torch.Generator) -> Dict[str, int]:
    """The text-to-motion program (``MLD.generate_feats``) counted whole and
    in its parts: the text condition over the CFG batch (the uncond row and
    the prompts through the tower), the sampler's step-invariant preamble
    (K1's time-embedding table and projected condition, hoisted out of the
    loop; 0 on the module path), one sampler step as the loop runs it, the
    number of steps, and the VAE decode. The whole run must equal
    text_condition + sampler_preamble + steps x sampler_step +
    vae_decode."""
    from mld_tpu_torch.ops.fused_denoiser import precompute_cond

    cond = mld.condition_embedding(token_ids)
    timesteps = mld.scheduler.timesteps()
    B = token_ids.shape[0]
    z = torch.randn((B, mld.latent_size, mld.latent_dim),
                    generator=generator, device=generator.device).to(
                        mld.device)
    model_in = torch.cat([z, z]) if mld.do_cfg else z
    t0 = int(timesteps[0])
    if mld.use_fused_denoiser():
        t_all = torch.as_tensor(timesteps, device=mld.device)
        time_tab, cond_lat = precompute_cond(mld.denoiser, t_all, cond)
        preamble = count(lambda: precompute_cond(mld.denoiser, t_all, cond))
        step = count(lambda: mld.denoiser.fused_forward(
            model_in, t0, cond, time_emb=time_tab[0], cond_lat=cond_lat))
    else:
        preamble = 0
        step = count(lambda: mld.denoise(model_in, t0, cond))
    return {
        "whole": count(lambda: mld.generate_feats(token_ids, mask,
                                                  generator=generator)),
        "text_condition": count(lambda: mld.condition_embedding(token_ids)),
        "sampler_preamble": preamble,
        "sampler_step": step,
        "steps": len(timesteps),
        "vae_decode": (count(lambda: mld.decode_latent(z, mask))
                       if mld.vae is not None else 0),
    }


def parts_total(parts: Dict[str, int]) -> int:
    """text_condition + sampler_preamble + steps x sampler_step +
    vae_decode."""
    return (parts["text_condition"] + parts["sampler_preamble"]
            + parts["steps"] * parts["sampler_step"] + parts["vae_decode"])
