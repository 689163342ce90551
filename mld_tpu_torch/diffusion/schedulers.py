"""DDIM and DDPM schedulers (port of ``mld_tpu/diffusion/schedulers.py``).

diffusers semantics as the reference configures them
(configs/modules/scheduler.yaml:2-43): ``scaled_linear`` betas
0.00085->0.012 over 1000 train steps, ``set_alpha_to_one=False`` (final
alpha = alphas_cumprod[0]), ``steps_offset=1``, eta 0.

The tables are built in numpy float64 and cast to f32, as the JAX package
does. Timesteps are host integers (the sampling loop is a Python loop), so
the per-step scalar coefficients are computed on the host in numpy float32,
with the same f32 operations the JAX step applies on device; only the
sample-sized arithmetic runs on the tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_beta_schedule(num_train_timesteps: int = 1000,
                       beta_start: float = 0.00085,
                       beta_end: float = 0.012,
                       beta_schedule: str = "scaled_linear") -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        return np.array([
            min(1 - alpha_bar((i + 1) / num_train_timesteps)
                / alpha_bar(i / num_train_timesteps), 0.999)
            for i in range(num_train_timesteps)])
    raise ValueError(f"unknown beta schedule {beta_schedule}")


_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Shared f32 tables (numpy, host side)."""
    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    num_train_timesteps: int
    prediction_type: str  # "epsilon" | "sample"
    clip_sample: bool

    @classmethod
    def create(cls, num_train_timesteps=1000, beta_start=0.00085,
               beta_end=0.012, beta_schedule="scaled_linear",
               prediction_type="epsilon", clip_sample=False):
        betas = make_beta_schedule(num_train_timesteps, beta_start, beta_end,
                                   beta_schedule)
        alphas = 1.0 - betas
        return cls(betas=betas.astype(_f32), alphas=alphas.astype(_f32),
                   alphas_cumprod=np.cumprod(alphas).astype(_f32),
                   num_train_timesteps=num_train_timesteps,
                   prediction_type=prediction_type, clip_sample=clip_sample)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) (``schedulers.py:77-84``): timesteps [B] integer,
        broadcast over the trailing dims; f32 table and square roots."""
        table = torch.as_tensor(self.alphas_cumprod, device=original.device)
        ac = table[timesteps.to(original.device, torch.long)]
        shape = ac.shape + (1,) * (original.dim() - ac.dim())
        sqrt_ac = torch.sqrt(ac).reshape(shape)
        sqrt_1mac = torch.sqrt(1.0 - ac).reshape(shape)
        return sqrt_ac * original + sqrt_1mac * noise

    def predict_x0_eps(self, model_output: torch.Tensor,
                       sample: torch.Tensor, alpha_prod_t: np.float32):
        beta_prod_t = _f32(1.0) - alpha_prod_t
        sqrt_a, sqrt_b = float(np.sqrt(alpha_prod_t)), float(np.sqrt(beta_prod_t))
        if self.prediction_type == "epsilon":
            x0 = (sample - sqrt_b * model_output) / sqrt_a
            eps = model_output
        elif self.prediction_type == "sample":
            x0 = model_output
            eps = (sample - sqrt_a * x0) / sqrt_b
        else:
            raise ValueError(self.prediction_type)
        if self.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
            eps = (sample - sqrt_a * x0) / sqrt_b
        return x0, eps


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    schedule: DiffusionSchedule
    num_inference_timesteps: int = 50
    eta: float = 0.0
    steps_offset: int = 1
    set_alpha_to_one: bool = False

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def timesteps(self) -> np.ndarray:
        """Descending inference timesteps, diffusers-exact."""
        T = self.schedule.num_train_timesteps
        n = self.num_inference_timesteps
        step_ratio = T // n
        ts = (np.arange(0, n) * step_ratio).round()[::-1].copy()
        return (ts + self.steps_offset).astype(np.int64)

    def step(self, model_output: torch.Tensor, timestep: int,
             sample: torch.Tensor, noise: torch.Tensor | None = None
             ) -> torch.Tensor:
        """One DDIM update x_t -> x_{t-dt} at host timestep `timestep`."""
        sch = self.schedule
        timestep = int(timestep)
        prev_t = timestep - sch.num_train_timesteps // self.num_inference_timesteps
        ac = sch.alphas_cumprod
        alpha_prod_t = ac[timestep]
        final_alpha = _f32(1.0) if self.set_alpha_to_one else ac[0]
        alpha_prod_prev = ac[prev_t] if prev_t >= 0 else final_alpha

        x0, eps = sch.predict_x0_eps(model_output, sample, alpha_prod_t)

        one = _f32(1.0)
        variance = ((one - alpha_prod_prev) / (one - alpha_prod_t)) * (
            one - alpha_prod_t / alpha_prod_prev)
        std = _f32(self.eta) * np.sqrt(variance)
        pred_dir = float(np.sqrt(one - alpha_prod_prev - std ** 2)) * eps
        prev_sample = float(np.sqrt(alpha_prod_prev)) * x0 + pred_dir
        if self.eta > 0 and noise is not None:
            prev_sample = prev_sample + float(std) * noise
        return prev_sample


@dataclasses.dataclass(frozen=True)
class DDPMScheduler:
    """Ancestral DDPM over every train timestep (``schedulers.py:177-221``),
    the sampler of the no-VAE presets."""
    schedule: DiffusionSchedule
    variance_type: str = "fixed_small"   # or "fixed_large"

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def timesteps(self) -> np.ndarray:
        """T-1, ..., 0."""
        T = self.schedule.num_train_timesteps
        return np.arange(T - 1, -1, -1, dtype=np.int64)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """The forward process of training (``schedulers.py:191-192``)."""
        return self.schedule.add_noise(original, noise, timesteps)

    def step(self, model_output: torch.Tensor, timestep: int,
             sample: torch.Tensor, noise: torch.Tensor | None = None
             ) -> torch.Tensor:
        """One ancestral update x_t -> x_{t-1} at host timestep `timestep`:
        the posterior mean from x0, plus std * noise (std 0 at t = 0).
        Without noise, the mean."""
        sch = self.schedule
        t = int(timestep)
        one = _f32(1.0)
        alpha_prod_t = sch.alphas_cumprod[t]
        alpha_prod_prev = sch.alphas_cumprod[t - 1] if t > 0 else one
        beta_t, alpha_t = sch.betas[t], sch.alphas[t]

        x0, _ = sch.predict_x0_eps(model_output, sample, alpha_prod_t)

        x0_coeff = np.sqrt(alpha_prod_prev) * beta_t / (one - alpha_prod_t)
        xt_coeff = np.sqrt(alpha_t) * (one - alpha_prod_prev) / (
            one - alpha_prod_t)
        prev_mean = float(x0_coeff) * x0 + float(xt_coeff) * sample
        if noise is None:
            return prev_mean
        variance = max(beta_t * (one - alpha_prod_prev) / (one - alpha_prod_t),
                       _f32(1e-20))
        if self.variance_type == "fixed_large":
            variance = beta_t
        std = np.sqrt(variance) if t > 0 else _f32(0.0)
        return prev_mean + float(std) * noise
