"""GAN model pair, counterpart of `locate_tpu/models/gan.py`: one generator
and one discriminator built from one config, and the latent and label
draws of a train step, from an explicit `torch.Generator`."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from locate_tpu_torch.config import Config, ModelConfig
from locate_tpu_torch.device import resolve_device
from locate_tpu_torch.models.discriminator import Discriminator
from locate_tpu_torch.models.generator import as_dtype, generator_of


@dataclasses.dataclass
class GAN:
    config: ModelConfig
    generator: torch.nn.Module   # `Generator` or `StyleGenerator`
    discriminator: Discriminator
    compute_dtype: torch.dtype

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device

    @property
    def num_ws(self) -> int:
        """The style family's styled-layer count (its mixing crossover's
        index space); 0 for the locate family."""
        return self.generator.num_ws

    def sample_latents(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """z ~ N(0, I), drawn in f32 and cast to the compute dtype."""
        z = torch.randn((n, self.config.latent_dim), generator=gen, device=gen.device)
        return z.to(self.compute_dtype)

    def sample_labels(self, gen: torch.Generator, n: int) -> Optional[torch.Tensor]:
        if not self.config.num_classes:
            return None
        return torch.randint(0, self.config.num_classes, (n,), generator=gen,
                             device=gen.device)


def shared_twin(module: torch.nn.Module, config: ModelConfig,
                compute_dtype: Optional[torch.dtype]) -> torch.nn.Module:
    """A module of `module`'s class built from `config` in `compute_dtype`
    whose parameters are `module`'s own tensors: gradients through it
    reach the same leaves, and an update of one is an update of the
    other."""
    gen = torch.Generator(device=next(module.parameters()).device)
    twin = type(module)(config, compute_dtype, gen)
    for name, p in module.named_parameters():
        owner, _, attr = name.rpartition(".")
        twin.get_submodule(owner)._parameters[attr] = p
    return twin


def model_config(cfg: Config) -> ModelConfig:
    """The model config both nets are built from: the top-level
    `use_pallas` switches the model's on."""
    if cfg.use_pallas and not cfg.model.use_pallas:
        return dataclasses.replace(cfg.model, use_pallas=True)
    return cfg.model


def build_gan(cfg: Config, device=None, seed: int = 0) -> GAN:
    """G and D with weights drawn from one `torch.Generator(device)` seeded
    with `seed` (G first), on the card unless `device="cpu"`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cd = as_dtype(cfg.train.compute_dtype)
    mcfg = model_config(cfg)
    return GAN(config=mcfg, generator=generator_of(mcfg, cd, gen),
               discriminator=Discriminator(mcfg, cd, gen), compute_dtype=cd)
