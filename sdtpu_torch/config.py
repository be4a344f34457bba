"""Model / scheduler / pipeline configuration.

Every architecture is a frozen dataclass, field for field the same as the
JAX package's ``sdtpu/config.py``, so one parameterized implementation covers
Tiny-SD, SD 1.5, SD 2.1 and SDXL.  Dtypes are torch dtypes.
``config_from_checkpoint`` reads a diffusers checkpoint directory's own JSON
configs into the same fields as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """CLIP text-encoder architecture."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    # "quick_gelu" (x * sigmoid(1.702 x)) or "gelu" (erf-exact).
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    # SDXL's second encoder (OpenCLIP bigG) reads the penultimate hidden state
    # and adds a text projection; SD 1.x reads the final LayerNorm output.
    use_final_layer_norm_output: bool = True
    projection_dim: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Conditional UNet architecture; the defaults are the Tiny-SD
    (BK-SDM-tiny) layout: three levels (320/640/1280), one resnet+attention
    per encoder level, two per decoder level, 8 heads, no mid block."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 1
    attention_levels: Tuple[bool, ...] = (True, True, True)
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1)
    # 0 is the fixed head_dim=64 sentinel (SD 2.x / SDXL)
    num_attention_heads: int = 8
    cross_attention_dim: int = 768
    mid_block: bool = False
    norm_num_groups: int = 32
    time_embed_dim_mult: int = 4  # time_embed_dim = block_out[0] * mult
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True
    addition_embed_dim: Optional[int] = None  # 2816 for SDXL base
    addition_time_embed_dim: Optional[int] = None  # 256 for SDXL base
    time_cond_proj_dim: Optional[int] = None  # LCM guidance embedding

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_dim_mult

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL architecture (standard SD: 32 groups, mid attention,
    (128, 256, 512, 512) widths)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DDPM scheduler constants (1000 train steps, scaled-linear betas)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear"
    prediction_type: str = "epsilon"  # or "v_prediction"
    steps_offset: int = 0
    timestep_spacing: str = "leading"  # or "trailing", "linspace"
    rescale_betas_zero_snr: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline preset: architectures + runtime policy."""

    name: str
    clip: Optional[CLIPConfig]
    unet: UNetConfig
    vae: VAEConfig
    scheduler: SchedulerConfig
    clip_2: Optional[CLIPConfig] = None
    requires_aesthetics_score: bool = False
    default_aesthetic_score: float = 6.0
    default_negative_aesthetic_score: float = 2.5
    default_image_size: int = 512
    default_steps: int = 25
    default_sampler: str = "ddpm"
    default_cfg: bool = True
    default_cfg_scale: float = 7.5
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    # The port routes latent self-attention through the flash kernel and
    # every resnet / up-block conv through the slab kernel ("auto"); on a
    # CPU tensor each kernel wrapper runs its plain PyTorch version.
    # attention_impl="ring" runs sequence-parallel ring attention over the
    # active sdtpu_torch.parallel.ring_context (dense where the token count
    # does not shard, e.g. the 77-token text context).  attention_impl="xla"
    # and conv_impl="xla" are the JAX package's non-Pallas route: dense
    # attention (F.scaled_dot_product_attention on a card) and GN -> SiLU ->
    # F.conv2d resnets; "gemm" is the same as "auto".
    attention_impl: str = "auto"
    conv_impl: str = "auto"

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    @property
    def text_config(self) -> CLIPConfig:
        return self.clip if self.clip is not None else self.clip_2


TINY_SD = PipelineConfig(
    name="segmind/tiny-sd",
    clip=CLIPConfig(),
    unet=UNetConfig(),
    vae=VAEConfig(),
    scheduler=SchedulerConfig(),
)

SD15 = PipelineConfig(
    name="runwayml/stable-diffusion-v1-5",
    clip=CLIPConfig(),
    unet=UNetConfig(
        block_out_channels=(320, 640, 1280, 1280),
        layers_per_block=2,
        attention_levels=(True, True, True, False),
        transformer_layers_per_block=(1, 1, 1, 1),
        num_attention_heads=8,
        cross_attention_dim=768,
        mid_block=True,
    ),
    vae=VAEConfig(),
    scheduler=SchedulerConfig(),
)

SD15_INPAINT = PipelineConfig(
    name="runwayml/stable-diffusion-inpainting",
    clip=CLIPConfig(),
    unet=dataclasses.replace(SD15.unet, in_channels=9),
    vae=VAEConfig(),
    scheduler=SchedulerConfig(),
)

IP2P = PipelineConfig(
    name="timbrooks/instruct-pix2pix",
    clip=CLIPConfig(),
    unet=dataclasses.replace(SD15.unet, in_channels=8),
    vae=VAEConfig(),
    scheduler=SchedulerConfig(),
)

SD21 = PipelineConfig(
    name="stabilityai/stable-diffusion-2-1",
    clip=CLIPConfig(
        hidden_size=1024,
        intermediate_size=4096,
        num_layers=23,
        num_heads=16,
        hidden_act="gelu",
    ),
    unet=UNetConfig(
        block_out_channels=(320, 640, 1280, 1280),
        layers_per_block=2,
        attention_levels=(True, True, True, False),
        transformer_layers_per_block=(1, 1, 1, 1),
        num_attention_heads=0,
        cross_attention_dim=1024,
        mid_block=True,
    ),
    vae=VAEConfig(),
    scheduler=SchedulerConfig(prediction_type="v_prediction"),
    default_image_size=768,
)

SDXL_BASE = PipelineConfig(
    name="stabilityai/stable-diffusion-xl-base-1.0",
    clip=CLIPConfig(use_final_layer_norm_output=False),
    clip_2=CLIPConfig(
        hidden_size=1280,
        intermediate_size=5120,
        num_layers=32,
        num_heads=20,
        hidden_act="gelu",
        use_final_layer_norm_output=False,
        projection_dim=1280,
    ),
    unet=UNetConfig(
        block_out_channels=(320, 640, 1280),
        layers_per_block=2,
        attention_levels=(False, True, True),
        transformer_layers_per_block=(1, 2, 10),
        num_attention_heads=0,
        cross_attention_dim=2048,
        mid_block=True,
        addition_embed_dim=2816,
        addition_time_embed_dim=256,
    ),
    vae=VAEConfig(scaling_factor=0.13025),
    scheduler=SchedulerConfig(),
    default_image_size=1024,
)

SDXL_REFINER = PipelineConfig(
    name="stabilityai/stable-diffusion-xl-refiner-1.0",
    clip=None,
    clip_2=SDXL_BASE.clip_2,
    unet=UNetConfig(
        block_out_channels=(384, 768, 1536, 1536),
        layers_per_block=2,
        attention_levels=(False, True, True, False),
        transformer_layers_per_block=(1, 4, 4, 4),
        num_attention_heads=0,
        cross_attention_dim=1280,
        mid_block=True,
        addition_embed_dim=2560,
        addition_time_embed_dim=256,
    ),
    vae=VAEConfig(scaling_factor=0.13025),
    scheduler=SchedulerConfig(),
    default_image_size=1024,
    requires_aesthetics_score=True,
)

SDXL_INPAINT = PipelineConfig(
    name="diffusers/stable-diffusion-xl-1.0-inpainting-0.1",
    clip=SDXL_BASE.clip,
    clip_2=SDXL_BASE.clip_2,
    unet=dataclasses.replace(SDXL_BASE.unet, in_channels=9),
    vae=SDXL_BASE.vae,
    scheduler=SchedulerConfig(),
    default_image_size=1024,
)

LCM_SD15 = PipelineConfig(
    name="SimianLuo/LCM_Dreamshaper_v7",
    clip=CLIPConfig(),
    unet=dataclasses.replace(SD15.unet, time_cond_proj_dim=256),
    vae=VAEConfig(),
    scheduler=SchedulerConfig(),
    default_steps=4,
    default_sampler="lcm",
    default_cfg=False,
    default_cfg_scale=8.0,
)

SDXL_TURBO = PipelineConfig(
    name="stabilityai/sdxl-turbo",
    clip=SDXL_BASE.clip,
    clip_2=SDXL_BASE.clip_2,
    unet=SDXL_BASE.unet,
    vae=SDXL_BASE.vae,
    scheduler=SchedulerConfig(),
    default_image_size=512,
    default_steps=4,
    default_sampler="euler",
    default_cfg=False,
    default_cfg_scale=1.0,
)

PRESETS = {
    "segmind/tiny-sd": TINY_SD,
    "tiny-sd": TINY_SD,
    "runwayml/stable-diffusion-v1-5": SD15,
    "sd15": SD15,
    "runwayml/stable-diffusion-inpainting": SD15_INPAINT,
    "sd15-inpaint": SD15_INPAINT,
    "timbrooks/instruct-pix2pix": IP2P,
    "instruct-pix2pix": IP2P,
    "ip2p": IP2P,
    "stabilityai/stable-diffusion-2-1": SD21,
    "sd21": SD21,
    "stabilityai/stable-diffusion-xl-base-1.0": SDXL_BASE,
    "sdxl": SDXL_BASE,
    "stabilityai/stable-diffusion-xl-refiner-1.0": SDXL_REFINER,
    "sdxl-refiner": SDXL_REFINER,
    "diffusers/stable-diffusion-xl-1.0-inpainting-0.1": SDXL_INPAINT,
    "sdxl-inpaint": SDXL_INPAINT,
    "SimianLuo/LCM_Dreamshaper_v7": LCM_SD15,
    "lcm-sd15": LCM_SD15,
    "stabilityai/sdxl-turbo": SDXL_TURBO,
    "sdxl-turbo": SDXL_TURBO,
}


def get_preset(name: str) -> PipelineConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None


# ---------------------------------------------------------------------------
# Config inference from a diffusers checkpoint directory (its JSON configs).
# ---------------------------------------------------------------------------


def _read_json(path):
    import json

    with open(path) as f:
        return json.load(f)


def _clip_from_json(cfg: dict, *, penultimate: bool) -> CLIPConfig:
    """HF CLIPText(Model|ModelWithProjection) config.json -> CLIPConfig."""
    with_proj = "CLIPTextModelWithProjection" in tuple(cfg.get("architectures") or ())
    return CLIPConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        max_length=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        use_final_layer_norm_output=not penultimate,
        projection_dim=cfg.get("projection_dim") if with_proj else None,
    )


def _unet_from_json(cfg: dict) -> UNetConfig:
    """diffusers UNet2DConditionModel config.json -> UNetConfig."""
    bocs = tuple(cfg["block_out_channels"])
    n = len(bocs)
    down = cfg.get("down_block_types", ["CrossAttnDownBlock2D"] * n)
    attention_levels = tuple("CrossAttn" in t for t in down)

    # diffusers' ``attention_head_dim`` is the head COUNT for SD 1.x (an int,
    # 8) and a per-level list of head counts giving head_dim 64 for SD 2.x /
    # SDXL (the num_attention_heads == 0 sentinel); ``num_attention_heads``,
    # when present, wins.
    heads = cfg.get("num_attention_heads") or cfg.get("attention_head_dim", 8)
    if isinstance(heads, (list, tuple)):
        dims = {bocs[i] // heads[i] for i in range(n) if attention_levels[i]}
        if dims == {64}:
            num_heads = 0
        elif len({heads[i] for i in range(n) if attention_levels[i]}) == 1:
            num_heads = next(heads[i] for i in range(n) if attention_levels[i])
        else:
            raise ValueError(
                f"unsupported per-level attention heads {heads!r} "
                f"(neither head_dim=64 nor a constant head count)"
            )
    else:
        num_heads = int(heads)

    tl = cfg.get("transformer_layers_per_block", 1)
    if not isinstance(tl, (list, tuple)):
        tl = [tl] * n

    lpb = cfg.get("layers_per_block", 2)
    if isinstance(lpb, (list, tuple)):
        if len(set(lpb)) != 1:
            raise ValueError(f"unsupported per-level layers_per_block {lpb!r}")
        lpb = lpb[0]

    addition_embed_dim = None
    if cfg.get("addition_embed_type") == "text_time":
        addition_embed_dim = cfg["projection_class_embeddings_input_dim"]

    return UNetConfig(
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=bocs,
        layers_per_block=lpb,
        attention_levels=attention_levels,
        transformer_layers_per_block=tuple(tl),
        num_attention_heads=num_heads,
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        mid_block=cfg.get("mid_block_type", "UNetMidBlock2DCrossAttn") is not None,
        norm_num_groups=cfg.get("norm_num_groups", 32),
        freq_shift=cfg.get("freq_shift", 0),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        addition_embed_dim=addition_embed_dim,
        addition_time_embed_dim=(cfg.get("addition_time_embed_dim")
                                 if addition_embed_dim is not None else None),
        time_cond_proj_dim=cfg.get("time_cond_proj_dim"),
    )


def _vae_from_json(cfg: dict) -> VAEConfig:
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def _scheduler_from_json(cfg: dict) -> SchedulerConfig:
    return SchedulerConfig(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
        prediction_type=cfg.get("prediction_type", "epsilon"),
        steps_offset=cfg.get("steps_offset", 0),
        timestep_spacing=cfg.get("timestep_spacing", "leading"),
        rescale_betas_zero_snr=cfg.get("rescale_betas_zero_snr", False),
    )


def config_from_checkpoint(model_dir: str) -> PipelineConfig:
    """A :class:`PipelineConfig` from a diffusers-layout checkpoint
    directory's own JSON configs (``unet/config.json``, ``vae/config.json``,
    ``text_encoder[_2]/config.json``, ``scheduler/scheduler_config.json``),
    so a checkpoint loads without a matching preset.

    The SDXL refiner's aesthetic-score conditioning is detected from the
    UNet's addition-embedding width: ``pooled + 5 * 256`` (5 time ids)
    against the base's 6."""
    import os

    unet_path = os.path.join(model_dir, "unet", "config.json")
    if not os.path.isfile(unet_path):
        raise ValueError(
            f"{model_dir!r} is not a diffusers checkpoint directory "
            "(missing unet/config.json)"
        )
    unet_json = _read_json(unet_path)
    unet = _unet_from_json(unet_json)
    vae = _vae_from_json(_read_json(os.path.join(model_dir, "vae", "config.json")))

    te2_path = os.path.join(model_dir, "text_encoder_2", "config.json")
    clip_2 = (_clip_from_json(_read_json(te2_path), penultimate=True)
              if os.path.isfile(te2_path) else None)
    te_path = os.path.join(model_dir, "text_encoder", "config.json")
    # SDXL-family pipelines read the penultimate hidden state of the first
    # encoder too (signalled by the presence of a second encoder)
    clip = (_clip_from_json(_read_json(te_path), penultimate=clip_2 is not None)
            if os.path.isfile(te_path) else None)
    if clip is None and clip_2 is None:
        raise ValueError(f"{model_dir!r} has no text_encoder config")

    sched_path = os.path.join(model_dir, "scheduler", "scheduler_config.json")
    scheduler = (_scheduler_from_json(_read_json(sched_path))
                 if os.path.isfile(sched_path) else SchedulerConfig())

    requires_aesthetics = False
    if unet.addition_embed_dim is not None and clip_2 is not None:
        pooled = clip_2.projection_dim or clip_2.hidden_size
        n_ids = (unet.addition_embed_dim - pooled) // (unet.addition_time_embed_dim or 256)
        requires_aesthetics = n_ids == 5

    sample = unet_json.get("sample_size", 64)
    downscale = 2 ** (len(vae.block_out_channels) - 1)
    lcm = unet.time_cond_proj_dim is not None
    return PipelineConfig(
        name=os.path.basename(model_dir.rstrip("/")) or model_dir,
        clip=clip,
        unet=unet,
        vae=vae,
        scheduler=scheduler,
        clip_2=clip_2,
        requires_aesthetics_score=requires_aesthetics,
        default_image_size=sample * downscale,
        default_cfg=not lcm,
        default_sampler="lcm" if lcm else "ddpm",
        default_steps=4 if lcm else 25,
    )
