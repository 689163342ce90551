"""Latent trajectories across the denoising steps (the twin of
``scripts/tsne.py``): the sampler's loop with every intermediate latent
kept, embedded in 2-D by PCA or a small exact t-SNE (numpy; no sklearn),
plotted with matplotlib's Agg backend.

    python -m mld_tpu_torch.scripts.tsne --preset mld_humanml3d \
        --out tsne.png [--method pca|tsne] [--device cuda]

``pca_2d`` and ``tsne_2d`` are numpy copies of the JAX script's (which
imports JAX at its top). Drawing needs matplotlib and raises without it.
Runs on the card unless ``--device`` names another; without a visible
CUDA device the default raises.
"""
import argparse

import numpy as np
import torch


@torch.no_grad()
def diffusion_reverse_trajectory(mld, cond_emb: torch.Tensor,
                                 generator=None, init_latents=None
                                 ) -> torch.Tensor:
    """``MLD.diffusion_reverse`` with the latents of every step stacked
    (the reference's ``_diffusion_reverse_tsne``, ``mld.py:362-424``):
    cond_emb [2B, S, D] under CFG (uncond half first) else [B, S, D] ->
    [steps, B, latent_size, latent_dim]. `init_latents` replaces the
    initial draw from `generator` (scaled by init_noise_sigma). Each step is
    ``MLD.denoise`` (K1 on the card where it serves) and the scheduler's
    step; the latent family's DDIM draws no noise."""
    B = cond_emb.shape[0] // 2 if mld.do_cfg else cond_emb.shape[0]
    shape = (B, mld.latent_size, mld.latent_dim)
    if init_latents is None:
        dev = generator.device if generator is not None else mld.device
        init_latents = (torch.randn(shape, generator=generator, device=dev)
                        * mld.scheduler.init_noise_sigma)
    latents = init_latents.to(mld.device, torch.float32)
    traj = []
    for t in mld.scheduler.timesteps():
        model_in = torch.cat([latents, latents]) if mld.do_cfg else latents
        out = mld.denoise(model_in, int(t), cond_emb)
        if mld.do_cfg:
            u, c = out.chunk(2)
            out = u + mld.guidance_scale * (c - u)
        latents = mld.scheduler.step(out, int(t), latents)
        traj.append(latents)
    return torch.stack(traj)


def full_context_condition(mld, texts) -> torch.Tensor:
    """The prompts' condition over the CFG batch with a full-context uncond
    row (``MLD.uncond_ids`` is EOT-cropped for serving and cannot
    concatenate with 77-token ids)."""
    ids = torch.as_tensor(mld.tokenizer(list(texts)), device=mld.device)
    if not mld.do_cfg:
        return mld.encode_text_tokens(ids)
    uncond = torch.as_tensor(mld.tokenizer([""]),
                             device=mld.device).expand_as(ids)
    return mld.encode_text_tokens(torch.cat([uncond, ids]))


def pca_2d(x: np.ndarray) -> np.ndarray:
    x = x - x.mean(0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:2].T


def tsne_2d(x: np.ndarray, perplexity=15.0, iters=400, lr=100.0,
            seed=0) -> np.ndarray:
    """Compact exact t-SNE (O(n^2)) — fine for a few hundred latents."""
    n = x.shape[0]
    rng = np.random.RandomState(seed)
    d2 = np.sum((x[:, None] - x[None]) ** 2, -1)

    # binary-search per-point precision for the target perplexity
    P = np.zeros((n, n))
    target = np.log(perplexity)
    for i in range(n):
        lo, hi, beta = 1e-20, 1e20, 1.0
        di = np.delete(d2[i], i)
        for _ in range(40):
            p = np.exp(-di * beta)
            s = p.sum() + 1e-12
            H = np.log(s) + beta * (di * p).sum() / s
            if H > target:
                lo = beta
                beta = beta * 2 if hi > 1e19 else (beta + hi) / 2
            else:
                hi = beta
                beta = (beta + lo) / 2
        row = np.exp(-d2[i] * beta)
        row[i] = 0
        P[i] = row / (row.sum() + 1e-12)
    P = (P + P.T) / (2 * n)
    P = np.maximum(P, 1e-12)

    y = 1e-4 * rng.randn(n, 2)
    vel = np.zeros_like(y)
    for it in range(iters):
        yd2 = np.sum((y[:, None] - y[None]) ** 2, -1)
        num = 1.0 / (1.0 + yd2)
        np.fill_diagonal(num, 0)
        Q = np.maximum(num / num.sum(), 1e-12)
        PQ = (P - Q) * num
        grad = 4 * ((np.diag(PQ.sum(1)) - PQ) @ y)
        momentum = 0.5 if it < 100 else 0.8
        vel = momentum * vel - lr * grad
        y = y + vel
        y = y - y.mean(0)
    return y


def plot(emb: np.ndarray, texts, method: str, out: str):
    """The trajectories emb [steps, B, 2] as a PNG at `out`."""
    try:
        import matplotlib
    except ImportError as err:
        raise RuntimeError("drawing the trajectories needs matplotlib, which "
                           "is not installed") from err
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 6))
    for b in range(emb.shape[1]):
        ax.plot(emb[:, b, 0], emb[:, b, 1], "-o", markersize=2,
                alpha=0.7, label=texts[b][:30])
        ax.scatter(emb[-1, b, 0], emb[-1, b, 1], marker="*", s=120)
    ax.legend(fontsize=7)
    ax.set_title(f"latent denoising trajectories ({method})")
    fig.savefig(out, dpi=120)
    plt.close(fig)


def embed(traj: np.ndarray, method: str) -> np.ndarray:
    """[steps, B, ...] latents -> [steps, B, 2]."""
    S, B = traj.shape[:2]
    flat = traj.reshape(S * B, -1)
    emb = pca_2d(flat) if method == "pca" else tsne_2d(flat)
    return emb.reshape(S, B, 2)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="latent trajectories "
                                            "(PyTorch port)")
    p.add_argument("--preset", default="mld_humanml3d")
    p.add_argument("--cfg", default=None)
    p.add_argument("--texts", nargs="*", default=[
        "a person walks forward", "a person jumps",
        "someone sits down", "a person waves"])
    p.add_argument("--out", default="tsne_latents.png")
    p.add_argument("--method", choices=["pca", "tsne"], default="tsne")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.models.mld import MLD, resolve_device
    from mld_tpu_torch.utils.checkpoint import load_pretrained

    device = resolve_device(args.device)
    cfg = load_config(args.cfg, None, preset=args.preset)
    mld = MLD(cfg, device=device, generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        load_pretrained(mld, args.checkpoint)
        mld.drop_stacks()
    cond = full_context_condition(mld, args.texts)
    traj = diffusion_reverse_trajectory(
        mld, cond, torch.Generator(device=device).manual_seed(0))
    traj = traj.cpu().numpy()  # [steps, B, latent_size, latent_dim]
    emb = embed(traj, args.method)
    plot(emb, args.texts, args.method, args.out)
    print(f"saved {args.out}  trajectories={traj.shape}")
    return traj, emb


if __name__ == "__main__":
    main()
