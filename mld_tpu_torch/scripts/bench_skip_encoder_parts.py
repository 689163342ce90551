"""Where the time of K1's bf16 arm goes on the card: the denoiser stack
(``csrc/skip_encoder.cu``, ``skip_encoder_kernel<__nv_bfloat16>``) whole and
with parts of it switched off, at the shapes the port serves it.

    python -m mld_tpu_torch.scripts.bench_skip_encoder_parts [--iters 20] \\
        [--json out.json]

Each variant is the kernel's source with a few lines replaced before nvcc
builds it into ``build/skip_encoder_parts/`` (every replacement is asserted,
so a change of the source fails here first):

- ``whole``: the kernel as it is;
- ``copies``: the weights alone: the producer's bulk copies through the
  ring, the consumers taking each stage and freeing it, with no product,
  store, exchange, LayerNorm or attention;
- ``products``: everything but the weights' bytes: the ring's protocol
  runs, the stages hold whatever they held, nothing is copied;
- ``no_sync``: the whole kernel without the cluster's exchange (the copies
  into the other blocks and the waits on their arrivals).

The whole kernel's time lies between the larger of ``copies`` and
``products`` (everything overlapped) and their sum (nothing overlapped);
``whole`` less ``no_sync`` is what the exchange costs on the chain. The
variants' outputs are wrong by design and not read. Each time is ms a
launch by CUDA events over ``--iters`` launches through the C entry, on
seeded random inputs and weights at the flagship widths (S=3, D=256, H=4,
F=1024). Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from mld_tpu_torch.ops import _build, fused_layer
from mld_tpu_torch.ops.transformer import SkipTransformerEncoder
from mld_tpu_torch.scripts import _bench

S, D, H, FF = 3, 256, 4, 1024
# (label, sequences, layers): B=128 under CFG at mld_humanml3d's 9 layers
# and mld_humanact12's 15, and B=512 under CFG at 9
SHAPES = (("t2m_b128", 256, 9), ("a2m_b128", 256, 15), ("t2m_b512", 1024, 9))
# lines of csrc/skip_encoder.cu and what they become in each variant, with
# the number of times each occurs
_NO_EXCHANGE = (("if (c > 1) exchange(", "if (false) exchange(", 1),)
_WEIGHTS_ONLY = _NO_EXCHANGE + (
    ("wgmma_bf16_ss_n32(acc[kk], smem_desc_sw128(a + 32 * kk, kSBO),",
     "if (false) wgmma_bf16_ss_n32(acc[kk], smem_desc_sw128(a + 32 * kk, kSBO),",
     1),
    ("store_tile(acc, f, t, b, kind, out, os, res, hid);", ";", 1),
    # the steps between products: LayerNorm, attention, the skip stack
    ("      if (!producer) {\n", "      if (false) {\n", 1),
    ("    if (!producer) {\n", "    if (false) {\n", 3),
)
_NO_COPIES = (
    ("mbar_expect_bytes(&rg.full[rg.slot], (unsigned)kTileBytes);",
     "mbar_arrive(&rg.full[rg.slot]);", 1),
    ("bulk_copy(rg.base + rg.slot * kTileBytes, src, kTileBytes, &rg.full[rg.slot]);",
     "(void)src;", 1),
)
VARIANTS = {"whole": (), "copies": _WEIGHTS_ONLY, "products": _NO_COPIES,
            "no_sync": _NO_EXCHANGE}


def _stack(layers: int, seed: int):
    """The bf16 stack of a seeded random encoder of `layers` layers."""
    from mld_tpu_torch.models.mld import init_params
    encoder = SkipTransformerEncoder(D, H, layers, FF)
    init_params(encoder, torch.Generator().manual_seed(seed))
    return fused_layer.stack_skip_encoder(encoder.to("cuda"), torch.bfloat16)


def run(iters: int) -> dict:
    device = _bench.resolve_device("cuda")
    header = _bench.header(device)
    print(f"[parts] {header['device']} ({header['nvidia_smi']}), torch "
          f"{header['torch']}, CUDA {header['cuda']}", flush=True)
    out_dir = str(_build.BUILD_DIR / "skip_encoder_parts")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda kv: _bench.build_variant("skip_encoder.cu",
                                            "mld_skip_encoder_forward", *kv,
                                            out_dir),
            VARIANTS.items())))
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, n_seq, layers in SHAPES:
        st = _stack(layers, layers)
        n_block = (layers - 1) // 2
        x = torch.randn(n_seq, S, D, device="cuda", generator=g)
        fused_layer._check(x, st, n_block, H)
        args, _out, _skip = fused_layer.launch_args(x, st, n_block, H)
        row = {"shape": label, "seqs": n_seq, "layers": layers}
        for name, fn in libs.items():
            def launch(fn=fn, name=name):
                err = fn(*args, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: cudaError {err}")
            row[f"{name}_ms"] = _bench.time_ms(launch, device, iters, 3)
        rows.append(row)
        print(f"[parts] {label} ({n_seq} seqs, L={layers}): " + ", ".join(
            f"{n} {row[f'{n}_ms']:.4f} ms" for n in VARIANTS), flush=True)
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
