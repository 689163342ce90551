"""Where the time of K3's reduced arms goes on the card: the one-sweep kernel
(``csrc/flash_attention.cu:flash_reduced_kernel``) whole and with parts of
it switched off, at the shapes the port serves it.

    python -m mld_tpu_torch.scripts.bench_flash_reduced_parts [--iters 20] \\
        [--json out.json]

Each variant is the kernel's source with a few lines replaced before nvcc
builds it into ``build/reduced_parts/`` (every replacement is asserted, so
a change of the source fails here first):

- ``whole``: the kernel as it is;
- ``copies``: the TMA copies and the conversion into the arm's type, with
  the products, the softmax and the output dropped (every compute warp
  idle but for its part of the protocol);
- ``products``: the products, the softmax and the output on whatever the
  tiles hold, with no bytes copied and nothing converted;
- ``no_mma``: ``products`` without its tensor-core instructions, so
  ``products`` less ``no_mma`` is what the MMAs take (what another product
  instruction, such as wgmma, could save at most).

The whole kernel's time lies between the larger of the two parts
(everything overlapped) and their sum (nothing overlapped). The variants'
outputs are wrong by design and not read. Each time is ms a launch by CUDA
events over ``--iters`` launches through the C entry, on f32 head views of
a packed QKV projection, no key mask. Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from mld_tpu_torch.ops import _build, attention
from mld_tpu_torch.scripts import _bench

# (label, B, H, Sq, Sk, Dh): the plain VAE decode's self-attention against
# [latent; frames], hidden mode's denoiser, raw motion's denoiser and
# s512's self-attention
SHAPES = (
    ("decode", 128, 4, 196, 197, 64),
    ("hidden", 256, 4, 79, 79, 64),
    ("raw", 256, 4, 198, 198, 128),
    ("s512", 12, 4, 512, 512, 128),
)
# lines of csrc/flash_attention.cu and what they become in each variant
_NO_PRODUCTS = ("const bool active = R::kWG || row0 < Sq;",
                "const bool active = false;")
_NO_COPIES = (
    ("mbar_expect_bytes(&full[s], (unsigned)R::kStageBytes);",
     "mbar_expect_bytes(&full[s], 0u);"),
    ("tma_load_4d(stage + s * R::kStageFloats, tm, 0, c[0], c[1], c[2],\n"
     "                    &full[s]);", ";"),
    ("for (int j = 0; j < DHP / 16; ++j) {\n        const int col",
     "for (int j = 0; j < 0; ++j) {\n        const int col"),
    ("for (int j = 0; j < DHP / 16; ++j) {\n        const int c =",
     "for (int j = 0; j < 0; ++j) {\n        const int c ="),
)
_NO_MMA = (
    ("mma_bf16(s4[nt], qf[kk], bf);", ";"),
    ("mma_tf32(s4[nt], qf[kk], bf);", ";"),
    ("mma_bf16(a0, pa[c], b0);", ";"),
    ("mma_bf16(a1, pa[c], b1);", ";"),
    ("mma_tf32(a, pb[kc], bf);", ";"),
    ("wgmma_bf16_n32(d, qf[kk], desc, kk > 0);", ";"),
    ("wgmma_tf32_n32(d, qf[kk], desc, kk > 0);", ";"),
    ("wgmma_tf32(d, pb[kc], smem_desc_sw128(vt + 32 * kc, 1024), 1);", ";"),
)
VARIANTS = {"whole": (), "copies": (_NO_PRODUCTS,), "products": _NO_COPIES,
            "no_mma": _NO_COPIES + _NO_MMA}


def _operands(B, H, Sq, Sk, Dh, g):
    """q, k, v as head views of packed projections, as the port's
    attention hands them over."""
    d = H * Dh
    qkv = torch.randn(B, max(Sq, Sk), 3 * d, device="cuda", generator=g)
    q, k, v = (t.reshape(B, -1, H, Dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    return q[:, :, :Sq], k[:, :, :Sk], v[:, :, :Sk]


def run(iters: int) -> dict:
    device = _bench.resolve_device("cuda")
    header = _bench.header(device)
    print(f"[parts] {header['device']} ({header['nvidia_smi']}), torch "
          f"{header['torch']}, CUDA {header['cuda']}", flush=True)
    out_dir = str(_build.BUILD_DIR / "reduced_parts")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda kv: _bench.build_variant("flash_attention.cu",
                                            "mld_flash_forward", *kv,
                                            out_dir),
            VARIANTS.items())))
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, B, H, Sq, Sk, Dh in SHAPES:
        q, k, v = _operands(B, H, Sq, Sk, Dh, g)
        for arith in ("bf16", "tf32"):
            _, args, _keep = attention.flash_operands(q, k, v, None, arith)
            row = {"shape": label, "q": [B, H, Sq, Dh], "sk": Sk,
                   "arithmetic": arith}
            for name, fn in libs.items():
                def launch(fn=fn):
                    err = fn(*args, stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: cudaError {err}")
                row[f"{name}_ms"] = _bench.time_ms(launch, device, iters, 3)
            rows.append(row)
            print(f"[parts] {label} {arith}: " + ", ".join(
                f"{n} {row[f'{n}_ms']:.4f} ms" for n in VARIANTS),
                flush=True)
    return {"header": header, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    report = run(args.iters)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
