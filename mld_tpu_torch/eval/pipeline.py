"""The evaluation protocol (the counterpart of ``mld_tpu/eval/pipeline.py``):

  text, per batch   generate (or VAE-reconstruct) -> joints -> renorm4t2m ->
                    length-descending sort -> the evaluators' embeddings
                    (reference mld.py:618-708, t2m_eval)
  action, per batch generate (or VAE-reconstruct) -> SMPL-topology joints
                    (HumanAct12: the GRU classifier) or rot6d rotations
                    (UESTC: the ST-GCN) -> accuracy, FID, diversity,
                    multimodality (mld.py:710-760, a2m_eval)
  replications      test.py:116-139: N passes, mean +- 1.96 std / sqrt(N)
  ground truth      mld.py:771-809 (eval_gt)

Metric accumulation and FID stay on the host in float64 (``metrics/``), as
in the reference. The evaluator networks run in f32 without TF32, in cuBLAS
and in cuDNN (the convolutions and the GRUs), for their own calls only
(``matmul_precision("highest")``, whatever MLD_TPU_MATMUL_PRECISION
says): the JAX package pins its measuring stick to "highest" matmul
precision so that serving-precision knobs never touch it.

Randomness: each batch's initial latents (``init_latents``, or ``eps`` of
the VAE stage) are drawn from one ``torch.Generator`` or given per batch by
the caller (``draws=``, as ``train/steps.py`` takes them), so a test can
replay the JAX package's draws. The host's metric RNG is
``np.random.RandomState(rep)`` a replication, as in the JAX package.

Where the port departs from the JAX package: the text protocol does not pad
ragged batches to a fixed size (a compile workaround there), so it has no
length-0 rows; and its MultiModality pass runs ``eval.batch_size`` texts x
``mm_num_repeats`` a batch, where the JAX package runs one text's repeats a
batch (the metric groups the repeats of each text either way). The action
protocol pads the ragged last batch to ``eval.batch_size`` and slices the
padding off, as the JAX package does (rows are independent, and a batch's
draws then have the JAX package's shape).

Data parallelism (``run_split(sharded=True)``, the JAX package's ``mesh=``
there): in a process group each rank evaluates its contiguous rows of
every batch, on the batch's draws made for all its rows, and the ranks'
outputs are gathered through ``parallel/multihost.py:make_metric_sync``
and put back in the unsharded batch's length order before they reach the
metrics (R-precision ranks groups of consecutive rows), so every rank
computes the unsharded pass's metrics.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mld_tpu_torch.metrics import (ComputeMetrics, HUMANACTMetrics,
                                   MMMetrics, MRMetrics, TM2TMetrics,
                                   UESTCMetrics, UncondMetrics)
from mld_tpu_torch.models.mld import crop_to_bucket, resolve_device
from mld_tpu_torch.models.t2m_eval import (MotionEncoderBiGRUCo,
                                           MovementConvEncoder,
                                           TextEncoderBiGRUCo, init_evaluator)
from mld_tpu_torch.parallel import ddp
from mld_tpu_torch.parallel.multihost import make_metric_sync
from mld_tpu_torch.utils.checkpoint import load_params_npz
from mld_tpu_torch.utils.convert import (flax_t2m_to_state_dict,
                                         state_dict_to_flax_t2m)
from mld_tpu_torch.utils.precision import matmul_precision

# eval_batch's outputs in the batch's length order
SORTED = ("lat_t", "lat_m", "lat_rm")
# the JAX bundle's tree keys, the finest.tar keys, the bundle's attributes
NETS = (("text", "text_encoder", "textencoder"),
        ("move", "movement_encoder", "moveencoder"),
        ("motion", "motion_encoder", "motionencoder"))


class T2MEvaluatorBundle(nn.Module):
    """The three evaluator networks, frozen, on the card unless `device`
    names another.

    Weights, in order: `params` (the JAX bundle's {"text", "move",
    "motion"} tree of arrays); else the npz at ``cfg.eval.t2m_params_path``
    (``save_params_npz`` of such a tree, as ``eval/t2m_train.py`` writes
    it); else the reference's ``finest.tar`` under ``cfg.model.t2m_path``;
    else random weights from `seed` (synthetic pipelines and smoke runs:
    R-precision then sits at chance)."""

    def __init__(self, cfg, params: Optional[Mapping] = None, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        nfeats = cfg.dataset.nfeats
        self.textencoder = TextEncoderBiGRUCo(300, 15, 512, 512)
        self.moveencoder = MovementConvEncoder(nfeats - 4, 512, 512)
        self.motionencoder = MotionEncoderBiGRUCo(512, 1024, 512)
        npz = cfg.eval.t2m_params_path
        tar = os.path.join(cfg.model.t2m_path, "t2m", "text_mot_match",
                           "model", "finest.tar")
        if params is None and npz and os.path.exists(npz):
            params = load_params_npz(npz)
        if params is not None:
            for key, _, attr in NETS:
                getattr(self, attr).load_state_dict(
                    flax_t2m_to_state_dict(params[key]), strict=True)
        elif os.path.exists(tar):
            ckpt = torch.load(tar, map_location="cpu", weights_only=False)
            for _, tar_key, attr in NETS:
                getattr(self, attr).load_state_dict(ckpt[tar_key],
                                                    strict=True)
        else:
            init_evaluator(self, torch.Generator().manual_seed(seed))
        self.to(device)
        self.device = device
        self.eval()
        self.requires_grad_(False)

    def params_tree(self) -> Dict:
        """The weights as the JAX bundle's tree of numpy arrays."""
        return {key: state_dict_to_flax_t2m(getattr(self, attr).state_dict())
                for key, _, attr in NETS}

    def motion_embedding(self, feats: torch.Tensor, m_lens) -> torch.Tensor:
        """evaluator-normalised features [B, T, nfeats], lengths in units
        [B] -> [B, 512]."""
        with torch.no_grad(), matmul_precision("highest"):
            return self.motionencoder(self.moveencoder(feats[..., :-4]),
                                      m_lens)

    def text_embedding(self, word_embs, pos_ohot, text_lens) -> torch.Tensor:
        """[B, S, 300], [B, S, 15], [B] -> [B, 512]."""
        with torch.no_grad(), matmul_precision("highest"):
            return self.textencoder(word_embs, pos_ohot, text_lens)


class Evaluator:
    """The protocol over a data module's test (or val) split for one MLD
    model, on the model's device. ``times`` holds the wall seconds of each
    batch by pass ("main", "mm", "gt", "a2m") and the host's metric seconds
    a split ("metrics"). The action presets take no t2m bundle: their
    classifiers are built a pass (``make_a2m_accumulator``)."""

    def __init__(self, cfg, mld, datamodule,
                 t2m_params: Optional[Mapping] = None):
        self.cfg = cfg
        self.mld = mld
        self.dm = datamodule
        self.device = mld.device
        self.is_a2m = cfg.model.condition == "action"
        self.bundle = (None if self.is_a2m else
                       T2MEvaluatorBundle(cfg, t2m_params,
                                          device=self.device))
        self.unit_len = cfg.dataset.unit_len
        self.times = defaultdict(list)

    # ------------------------------------------------------ action-to-motion
    def make_a2m_accumulator(self, diversity_times: int):
        """The HumanAct12 / UESTC metric accumulator, its classifier on the
        model's device: the reference's frozen checkpoint when present
        (modeltype/base.py:154, metrics/stgcn.py:41); for HumanAct12 else the
        in-repo trained classifier (``humanact12_gru_params.npz``,
        ``eval/a2m_train.py``); else random weights."""
        cfg = self.cfg
        kw = dict(num_labels=cfg.model.nclasses,
                  diversity_times=diversity_times,
                  multimodality_times=cfg.eval.mm_num_times,
                  device=self.device)
        if cfg.dataset.name.lower() == "uestc":
            tar = os.path.join(cfg.model.uestc_rec_path,
                               "uestc_rot6d_stgcn.tar")
            if os.path.exists(tar):
                return UESTCMetrics.from_checkpoint(tar, **kw)
            return UESTCMetrics(**kw)
        tar = os.path.join(cfg.model.humanact12_rec_path,
                           "humanact12_gru.tar")
        if os.path.exists(tar):
            return HUMANACTMetrics.from_checkpoint(tar, **kw)
        npz = os.path.join(cfg.model.humanact12_rec_path,
                           "humanact12_gru_params.npz")
        if os.path.exists(npz):
            return HUMANACTMetrics(params=load_params_npz(npz), **kw)
        return HUMANACTMetrics(**kw)

    @torch.no_grad()
    def a2m_batch(self, batch: Mapping, stage: str,
                  draws: Mapping) -> Dict[str, torch.Tensor]:
        """One collated a2m batch -> the generated (or VAE-reconstructed)
        features "feats_rst" and the joints "joints_rst" / "joints_ref"
        (SMPL topology, with the root translation, zero outside the mask),
        on the device (``mld.py:710-760``)."""
        mld, dev = self.mld, self.device
        mask = torch.as_tensor(batch["mask"], device=dev)
        motion = torch.as_tensor(batch["motion"], device=dev)
        if stage == "diffusion":
            feats_rst = mld.generate_feats(
                torch.as_tensor(batch["action"], device=dev), mask,
                init_latents=draws["init_latents"])
        else:  # vae reconstruction
            feats_rst = mld.reconstruct(motion, mask, eps=draws["eps"])
        return {"feats_rst": feats_rst,
                "joints_rst": mld.feats2joints(feats_rst, mask),
                "joints_ref": mld.feats2joints(motion, mask)}

    @staticmethod
    def to_rots(feats: torch.Tensor) -> torch.Tensor:
        """[B, T, 150] features -> the ST-GCN's rot6d input [B, 24, 6, T]
        (base.py:895-903)."""
        B, T, _ = feats.shape
        return feats.reshape(B, T, 25, 6)[:, :, :24].permute(0, 2, 3, 1)

    def run_split_a2m(self, loader: Iterable, *, stage: str = "diffusion",
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Iterable[Mapping]] = None,
                      compute_rng: Optional[np.random.RandomState] = None,
                      diversity_times: Optional[int] = None,
                      prediction_sink=None) -> Dict[str, float]:
        """One metric pass over the a2m split (the allsplit_step a2m branch,
        mld.py:875-907): accuracy, FID, Diversity and Multimodality through
        the classifier. A ragged last batch is padded to ``eval.batch_size``
        (zero motion, mask and action) and the padding sliced off before the
        metrics. `draws` gives each batch's draws (of its padded rows);
        without it they come from `generator` (default: seeded with
        cfg.seed on the model's device)."""
        cfg = self.cfg
        acc = self.make_a2m_accumulator(diversity_times
                                        or cfg.eval.diversity_times)
        is_uestc = cfg.dataset.name.lower() == "uestc"
        if draws is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                cfg.seed)
        draws = iter(draws) if draws is not None else None
        for batch in loader:
            lengths = np.asarray(batch["length"])
            actions = np.asarray(batch["action"])
            n_real = len(actions)
            padded = {k: np.asarray(batch[k])
                      for k in ("motion", "mask", "action")}
            pad_n = cfg.eval.batch_size - n_real
            if pad_n > 0:
                padded = {k: np.concatenate(
                    [v, np.zeros((pad_n,) + v.shape[1:], v.dtype)])
                    for k, v in padded.items()}
            n, n_frames = padded["mask"].shape
            d = (next(draws) if draws is not None
                 else self.draw(n, n_frames, stage, generator))
            # a batch's time: generation and the classifier's two passes,
            # ending in the copy of their outputs to the host
            t0 = time.perf_counter()
            out = {k: v[:n_real]
                   for k, v in self.a2m_batch(padded, stage, d).items()}
            if prediction_sink is not None:
                prediction_sink(out["joints_rst"].cpu().numpy(), lengths)
            if is_uestc:
                acc.update(actions, self.to_rots(out["feats_rst"]),
                           self.to_rots(torch.as_tensor(
                               padded["motion"][:n_real])), lengths)
            else:
                acc.update(actions, out["joints_rst"], out["joints_ref"],
                           lengths)
            self.times["a2m"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        res = acc.compute(rng=compute_rng)
        self.times["metrics"].append(time.perf_counter() - t0)
        return {k: float(v) for k, v in res.items()}

    # ---------------------------------------------------------- one batch
    def draw(self, n_rows: int, n_frames: int, stage: str,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """A batch's draws: the initial latents of sampling (scaled by
        init_noise_sigma) or the VAE's eps."""
        mld = self.mld
        dev = generator.device
        if stage == "vae":
            shape = (n_rows, mld.latent_size, mld.latent_dim)
            return {"eps": torch.randn(shape, generator=generator,
                                       device=dev)}
        shape = ((n_rows, n_frames, mld.nfeats) if mld.raw_motion
                 else (n_rows, mld.latent_size, mld.latent_dim))
        return {"init_latents": torch.randn(shape, generator=generator,
                                            device=dev)
                * mld.scheduler.init_noise_sigma}

    @torch.no_grad()
    def eval_batch(self, batch: Mapping, stage: str, draws: Mapping,
                   mm: bool = False) -> Dict[str, np.ndarray]:
        """One collated batch -> the evaluator embeddings sorted by length,
        descending ("lat_t", "lat_m", "lat_rm", and "align", the order), and
        the joints in batch order ("joints_rst", "joints_ref"). With `mm`
        only "lat_rm" and "align", from "text_ids" (or, in the vae stage,
        "motion"), "mask" and "length". Returned on the host."""
        mld, dev = self.mld, self.device
        mask = torch.as_tensor(batch["mask"], device=dev)
        # a MultiModality batch of generations needs no reference motion
        motion = (torch.as_tensor(batch["motion"], device=dev)
                  if stage == "vae" or not mm else None)
        if stage == "diffusion":
            ids = torch.as_tensor(batch["text_ids"], dtype=torch.long)
            # the EOT crop is exact in features mode only; hidden mode
            # conditions on all 77 positions (mld.py:272-274)
            if mld.clip_mode == "features":
                ids = crop_to_bucket(ids)
            feats_rst = mld.generate_feats(ids.to(dev), mask,
                                           init_latents=draws["init_latents"])
        else:  # vae reconstruction (stage-1 eval)
            feats_rst = mld.reconstruct(motion, mask, eps=draws["eps"])

        lengths = torch.as_tensor(batch["length"]).long()
        # stable: synthetic lengths tie often, and an unstable order would
        # pair texts with other motions in R-precision
        align = torch.argsort(-lengths, stable=True)
        m_lens = lengths[align] // self.unit_len
        out = {"align": align.numpy()}
        align_d = align.to(dev)
        out["lat_rm"] = self.bundle.motion_embedding(
            mld.renorm4t2m(feats_rst)[align_d], m_lens)
        if not mm:
            out["lat_m"] = self.bundle.motion_embedding(
                mld.renorm4t2m(motion)[align_d], m_lens)
            out["lat_t"] = self.bundle.text_embedding(
                torch.as_tensor(batch["word_embs"], device=dev),
                torch.as_tensor(batch["pos_ohot"], device=dev),
                torch.as_tensor(batch["text_len"]))[align_d]
            keep = mask[..., None, None]
            out["joints_rst"] = mld.feats2joints(feats_rst) * keep
            out["joints_ref"] = mld.feats2joints(motion) * keep
        return {k: v.cpu().numpy() if torch.is_tensor(v) else v
                for k, v in out.items()}

    def eval_batch_sharded(self, batch: Mapping, stage: str, draws: Mapping,
                           mm: bool, sync) -> Dict[str, np.ndarray]:
        """eval_batch over the ranks of the process group: this rank's
        contiguous rows (with their rows of the batch's `draws`), every
        rank's outputs gathered by `sync` (``make_metric_sync``: rank
        order, so batch order) and sorted by the whole batch's lengths, as
        the unsharded eval_batch sorts them."""
        n = len(np.asarray(batch["mask"]))
        rank, world = ddp.rank(), ddp.world_size()
        sl = ddp.shard_bounds(n, rank, world)
        local = {}
        if sl.stop > sl.start:
            out = self.eval_batch(ddp.shard_rows(batch, rank, world), stage,
                                  {k: v[sl] for k, v in draws.items()}, mm)
            for k, v in out.items():
                if k in SORTED:     # back to the rows' batch order
                    local[k] = np.empty_like(v)
                    local[k][out["align"]] = v
                elif k != "align":
                    local[k] = v
        keys = ("lat_rm",) if mm else SORTED + ("joints_rst", "joints_ref")
        full = {k: sync([local[k]] if k in local else [])[0] for k in keys}
        align = torch.argsort(-torch.as_tensor(batch["length"]).long(),
                              stable=True).numpy()
        full = {k: v[align] if k in SORTED else v for k, v in full.items()}
        full["align"] = align
        return full

    # ------------------------------------------------------------ passes
    def _accumulators(self, metrics, mm, diversity_times):
        cfg = self.cfg
        if mm:
            return {"MMMetrics": MMMetrics(mm_num_times=cfg.eval.mm_num_times)}
        accs = {}
        if "TM2TMetrics" in metrics:
            accs["TM2TMetrics"] = TM2TMetrics(R_size=cfg.eval.r_size,
                                              diversity_times=diversity_times)
        if "TemosMetric" in metrics:
            ds = cfg.dataset.name.lower()
            if ds not in ("humanml3d", "kit"):
                raise TypeError(
                    "APE/AVE metrics only support humanml3d and kit")
            accs["TemosMetric"] = ComputeMetrics(
                njoints=cfg.dataset.njoints,
                jointstype="humanml3d" if ds == "humanml3d" else "mmm")
        if "MRMetrics" in metrics:
            accs["MRMetrics"] = MRMetrics(njoints=cfg.dataset.njoints)
        if "UncondMetrics" in metrics:
            accs["UncondMetrics"] = UncondMetrics(
                diversity_times=diversity_times)
        return accs

    def run_split(self, loader: Iterable, *, stage: str = "diffusion",
                  metrics=("TM2TMetrics", "TemosMetric"), mm: bool = False,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Iterable[Mapping]] = None,
                  compute_rng: Optional[np.random.RandomState] = None,
                  diversity_times: Optional[int] = None,
                  prediction_sink=None,
                  sharded: bool = False) -> Dict[str, float]:
        """One metric pass over `loader`'s batches. With `mm` each text is
        repeated ``eval.mm_num_repeats`` times and only MultiModality is
        computed. `draws` gives each batch's draws (of its rows after the
        repeat); without it they come from `generator` (default: seeded
        with cfg.seed on the model's device). `prediction_sink(joints,
        lengths)` receives each batch's generated joints. `sharded`: every
        rank of the process group calls this on the same batches and
        evaluates its rows of each (``eval_batch_sharded``); the metrics
        are the unsharded pass's, on every rank."""
        cfg = self.cfg
        div_times = diversity_times or cfg.eval.diversity_times
        accs = self._accumulators(metrics, mm, div_times)
        if draws is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                cfg.seed)
        draws = iter(draws) if draws is not None else None
        reps = cfg.eval.mm_num_repeats if mm else 1
        # what a MultiModality batch reads, repeated
        mm_keys = ("text_ids", "mask", "length") + (
            ("motion",) if stage == "vae" else ())
        sync = make_metric_sync() if sharded else None
        metric_s = 0.0
        for batch in loader:
            if mm:
                batch = {k: np.repeat(np.asarray(batch[k]), reps, axis=0)
                         for k in mm_keys}
            n, n_frames = np.asarray(batch["mask"]).shape
            d = (next(draws) if draws is not None
                 else self.draw(n, n_frames, stage, generator))
            t0 = time.perf_counter()
            out = (self.eval_batch(batch, stage, d, mm=mm) if sync is None
                   else self.eval_batch_sharded(batch, stage, d, mm, sync))
            self.times["mm" if mm else "main"].append(
                time.perf_counter() - t0)
            lengths = np.asarray(batch["length"])
            sorted_lengths = lengths[out["align"]]
            if prediction_sink is not None and not mm:
                prediction_sink(out["joints_rst"], lengths)
            t0 = time.perf_counter()
            if mm:
                # back to batch order: each text's repeats are consecutive
                lat = np.empty_like(out["lat_rm"])
                lat[out["align"]] = out["lat_rm"]
                lat = lat.reshape(n // reps, reps, -1)
                for i in range(n // reps):
                    accs["MMMetrics"].update(lat[i:i + 1],
                                             lengths[i * reps:i * reps + 1])
            if "TM2TMetrics" in accs:
                accs["TM2TMetrics"].update(out["lat_t"], out["lat_rm"],
                                           out["lat_m"], sorted_lengths)
            if "TemosMetric" in accs:
                accs["TemosMetric"].update(out["joints_rst"],
                                           out["joints_ref"], lengths)
            if "MRMetrics" in accs:
                accs["MRMetrics"].update(out["joints_rst"],
                                         out["joints_ref"], lengths)
            if "UncondMetrics" in accs:
                accs["UncondMetrics"].update(out["lat_m"], sorted_lengths,
                                             out["lat_rm"])
            metric_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        results = {}
        for acc in accs.values():
            try:
                results.update(acc.compute(rng=compute_rng))
            except TypeError:  # metric without an rng-aware compute
                results.update(acc.compute())
        self.times["metrics"].append(metric_s + time.perf_counter() - t0)
        return {k: float(v) for k, v in results.items()}

    @torch.no_grad()
    def run_gt(self, loader: Iterable) -> Dict[str, float]:
        """Ground truth against ground truth (mld.py:771-809 eval_gt): the
        dataset's own statistics, no generation."""
        mld, dev = self.mld, self.device
        acc = TM2TMetrics(R_size=self.cfg.eval.r_size,
                          diversity_times=self.cfg.eval.diversity_times)
        for batch in loader:
            t0 = time.perf_counter()
            lengths = torch.as_tensor(batch["length"]).long()
            align = torch.argsort(-lengths, stable=True)
            align_d = align.to(dev)
            motion = torch.as_tensor(batch["motion"], device=dev)
            lat_m = self.bundle.motion_embedding(
                mld.renorm4t2m(motion)[align_d],
                lengths[align] // self.unit_len).cpu().numpy()
            lat_t = self.bundle.text_embedding(
                torch.as_tensor(batch["word_embs"], device=dev),
                torch.as_tensor(batch["pos_ohot"], device=dev),
                torch.as_tensor(batch["text_len"]))[align_d].cpu().numpy()
            self.times["gt"].append(time.perf_counter() - t0)
            acc.update(lat_t, lat_m, lat_m, lengths[align].numpy())
        t0 = time.perf_counter()
        res = acc.compute()
        self.times["metrics"].append(time.perf_counter() - t0)
        return {k: float(v) for k, v in res.items()}

    def run(self, generator: Optional[torch.Generator] = None,
            replication_times: Optional[int] = None,
            stage: str = "diffusion", with_mm: bool = True,
            prediction_sink=None,
            draws: Optional[Sequence[Iterable[Mapping]]] = None
            ) -> Dict[str, float]:
        """The test protocol: `replication_times` passes over the test split
        (default ``cfg.test.replication_times``), each with its
        MultiModality pass, reported as mean and "<metric>/conf95" (1.96
        std / sqrt(N)). `prediction_sink` sees the first replication's main
        pass. `draws`, one iterable of batch draws a replication, replaces
        the main passes' draws from `generator` (``run_split``'s
        `draws`)."""
        cfg = self.cfg
        replication_times = replication_times or cfg.test.replication_times
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                cfg.seed)
        all_metrics: Dict[str, list] = {}
        for rep in range(replication_times):
            # a fresh host rng a replication: a new mm subset and metric
            # shuffle each time (test.py:116-131)
            rep_rng = np.random.RandomState(rep)
            sink = prediction_sink if rep == 0 else None
            loader = self.dm.loader("test", shuffle=False,
                                    batch_size=cfg.eval.batch_size)
            if self.is_a2m:
                res = self.run_split_a2m(loader, stage=stage,
                                         generator=generator,
                                         compute_rng=rep_rng,
                                         prediction_sink=sink)
                for k, v in res.items():
                    all_metrics.setdefault(k, []).append(float(v))
                continue
            res = self.run_split(loader, stage=stage,
                                 metrics=tuple(cfg.eval.metrics),
                                 generator=generator, compute_rng=rep_rng,
                                 prediction_sink=sink,
                                 draws=None if draws is None else draws[rep])
            if with_mm and "TM2TMetrics" in cfg.eval.metrics:
                self.dm.mm_mode(True, cfg.eval.mm_num_samples, rng=rep_rng)
                try:
                    mm_loader = self.dm.loader(
                        "test", shuffle=False, batch_size=cfg.eval.batch_size)
                    res.update(self.run_split(mm_loader, stage=stage, mm=True,
                                              generator=generator,
                                              compute_rng=rep_rng))
                finally:
                    self.dm.mm_mode(False)
            for k, v in res.items():
                all_metrics.setdefault(k, []).append(float(v))

        out = {}
        for k, vals in all_metrics.items():
            arr = np.asarray(vals)
            out[k] = float(arr.mean())
            out[f"{k}/conf95"] = float(1.96 * arr.std() / np.sqrt(len(arr)))
        return out
