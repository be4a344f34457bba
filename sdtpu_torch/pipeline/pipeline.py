"""Text-to-image pipeline.

Counterpart of ``sdtpu/pipeline/pipeline.py`` for txt2img with classifier-
free guidance and any of the JAX package's 13 samplers
(``samplers/__init__.py``).  The JAX package compiles the whole request
into one program; here it runs eagerly, in the same order:

1. CLIP on the token rows, ordered ``[cond..., uncond...]`` under CFG;
2. the cross-attention K/V of every transformer block and every time
   projection of every step, computed once before the loop;
3. per step: the latents doubled for CFG -> the sampler's
   ``scale_model_input`` -> ``unet_forward`` -> CFG combine -> the
   sampler's step (a stochastic one with that step's noise, a multistep
   one with its state);
4. ``vae_decode`` and the uint8 conversion, on the device.

``generate(seed=)`` draws the initial latents and the per-step noise as
the JAX package does (``sdtpu/pipeline/pipeline.py:1763-1780, 2062-2069``):
``key(uint32(seed))``, one split for the latents, then one split per step
for a stochastic sampler only, each draw a ``normal``
(``utils/prng.py``).  All of a request's draws run in one batched call
before the loop, on the device (on a card as one replayed CUDA graph).
``rng="torch"`` draws the initial latents from a CPU ``torch.Generator``
instead.  ``txt2img`` takes both as explicit tensors and scales the
initial latents by the schedule's ``init_sigma`` (sigma-space samplers).

``from_pretrained`` loads a local diffusers checkpoint directory
(``utils/weights.py:load_pipeline_params``).

Each stage runs inside ``utils/profiling.stage``: ``tokenize``, ``noise``,
``clip``, ``precompute``, ``unet_step`` (once per step), ``vae_decode``,
``to_uint8``.  With ``output="device"`` a request makes no host sync
between its tokens and the returned tensor.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from sdtpu_torch.config import PipelineConfig, get_preset
from sdtpu_torch.models.clip import clip_encode_windows
from sdtpu_torch.models.unet import (
    precompute_cross_kv,
    precompute_time_projections,
    time_cache_step,
    unet_forward,
)
from sdtpu_torch.models.vae import vae_decode
from sdtpu_torch.samplers import get_sampler
from sdtpu_torch.utils import prng
from sdtpu_torch.utils.image import to_uint8
from sdtpu_torch.utils.profiling import stage
from sdtpu_torch.utils.runtime import to_device

OUTPUTS = ("uint8", "float", "latents", "device")


def request_keys(key, steps: int, *, init: bool = True) -> np.ndarray:
    """One request's keys, as the JAX program derives them from its key:
    with ``init``, ``key, k_init = split(key)`` for the initial latents;
    then each step's ``key, sub = split(key)`` for its variance noise.
    (init + steps, 2) uint32."""
    keys = []
    if init:
        key, k_init = prng.split(key)
        keys.append(k_init)
    for _ in range(steps):
        key, sub = prng.split(key)
        keys.append(sub)
    return np.stack(keys)


def request_noise(key, steps: int, shape, device, *, init: bool = True,
                  graphs: Optional[prng.NormalGraphs] = None) -> torch.Tensor:
    """The normals of :func:`request_keys`, (init + steps, *shape) float32
    on ``device``, drawn in one batched call: by numpy on the CPU
    (``prng.normal``), by torch on a card (``prng.normal_torch``), through
    ``graphs`` (its CUDA graph replayed) where given."""
    keys = request_keys(key, steps, init=init)
    if torch.device(device).type == "cpu":
        return torch.from_numpy(np.stack([prng.normal(k, shape) for k in keys]))
    if graphs is not None:
        return graphs(keys, shape, device)
    return prng.normal_torch(keys, shape, device)


class PendingImages:
    """An in-flight :meth:`StableDiffusionPipeline.generate_async` result:
    the uint8 images as a device tensor whose work may still be queued.
    ``result()`` waits for it and copies it to the host."""

    __slots__ = ("device_images",)

    def __init__(self, device_images: torch.Tensor):
        self.device_images = device_images

    def result(self) -> np.ndarray:
        return self.device_images.cpu().numpy()


class StableDiffusionPipeline:
    """Tokenize on the host -> encode, denoise and decode on ``device``."""

    def __init__(self, config: PipelineConfig, params: dict, tokenizer=None,
                 *, device="cuda"):
        if config.attention_impl not in ("auto", "flash", "ring", "xla"):
            raise ValueError(f"unknown attention_impl {config.attention_impl!r}")
        if config.conv_impl not in ("auto", "gemm", "xla"):
            raise ValueError(f"unknown conv_impl {config.conv_impl!r}")
        self.config = config
        # "auto" is the kernel route on every device: on a CPU tensor each
        # kernel wrapper runs its plain version.  "ring" runs ring attention
        # over the ring_context active when generate is called (dense where
        # there is none).  "xla" is the JAX package's non-Pallas route, the
        # library's ops: dense attention (SDPA on a card) and F.conv2d
        # resnets; only a caller who asks for it gets it.
        self.attention_impl = {"ring": "ring", "xla": "xla"}.get(config.attention_impl, "flash")
        self.conv_impl = "xla" if config.conv_impl == "xla" else "gemm"
        self.params = params
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        # a request's draws on a card: one CUDA graph replay per request
        self._draws = prng.NormalGraphs() if self.device.type == "cuda" else None

    @classmethod
    def from_random(cls, preset: Union[str, PipelineConfig], *, seed: int = 0,
                    device="cuda", tokenizer=None) -> "StableDiffusionPipeline":
        """Seeded random weights (benchmarks and tests: speed does not depend
        on the weight values), equal to the JAX package's
        ``from_random``/``init_pipeline_params`` for the same ``seed``."""
        from sdtpu_torch.utils.weights import init_pipeline_params

        config = preset if isinstance(preset, PipelineConfig) else get_preset(preset)
        return cls(config, init_pipeline_params(seed, config, device=device),
                   tokenizer, device=device)

    @classmethod
    def from_pretrained(cls, model_dir: str, *, preset: Optional[str] = None, dtype=None,
                        device="cuda") -> "StableDiffusionPipeline":
        """Load a local diffusers-layout checkpoint directory.  The config: an
        explicit ``preset`` wins; else the directory's basename is looked up
        among the presets; else the checkpoint's own JSON configs give it
        (``config.config_from_checkpoint``).  ``dtype`` sets the param and
        compute dtypes.  The tokenizer comes from ``tokenizer/``, then
        ``tokenizer_2/``, then the repository's default assets.  A config
        the port cannot run yet (an SDXL add-embedding, an LCM guidance
        embedding, a second text encoder) raises NotImplementedError before
        any weight file is read."""
        import os

        from sdtpu_torch.config import PRESETS, config_from_checkpoint
        from sdtpu_torch.tokenizer.bpe import CLIPTokenizer
        from sdtpu_torch.utils.weights import load_pipeline_params

        if preset is not None:
            config = get_preset(preset)
        else:
            base = os.path.basename(model_dir.rstrip("/"))
            config = get_preset(base) if base in PRESETS else config_from_checkpoint(model_dir)
        unet = config.unet
        if unet.addition_embed_dim is not None or config.clip is None or config.clip_2 is not None:
            raise NotImplementedError(
                f"{config.name}: SDXL-family checkpoints (add-embedding, second text "
                "encoder) belong to the model-family slice")
        if unet.time_cond_proj_dim is not None:
            raise NotImplementedError(
                f"{config.name}: LCM guidance-embedding UNets belong to the model-family slice")
        if dtype is not None:
            config = config.replace(param_dtype=dtype, compute_dtype=dtype)
        params = load_pipeline_params(model_dir, config, device=device)
        tok_dir = os.path.join(model_dir, "tokenizer")
        if not os.path.isdir(tok_dir):
            tok_dir = os.path.join(model_dir, "tokenizer_2")
        tokenizer = (CLIPTokenizer.from_pretrained(tok_dir) if os.path.isdir(tok_dir)
                     else CLIPTokenizer.from_default_assets())
        return cls(config, params, tokenizer, device=device)

    @classmethod
    def from_params(cls, config: PipelineConfig, numpy_tree: dict, *, device="cuda",
                    tokenizer=None) -> "StableDiffusionPipeline":
        """The JAX package's parameter tree, as numpy arrays."""
        from sdtpu_torch.utils.weights import params_from_numpy

        return cls(config, params_from_numpy(numpy_tree, device=device), tokenizer,
                   device=device)

    def quantize_int8(self, *, vae: Optional[bool] = None, **kw) -> "StableDiffusionPipeline":
        """Quantize the UNet's resnet convs to int8 (W8A8) in place; returns
        self.  On the card each quantized resnet conv then runs the int8
        slab kernel (kernel D).  ``kw`` goes to
        ``utils/quant.py:quantize_pipeline_int8`` (``min_ch``,
        ``transformer=False|True|"full"``, ``skip_down``/``skip_up``,
        ``act_ranges``/``act_margin``, ``sigmas``).  ``vae=True`` adds the
        VAE decoder's resnet convs; ``vae=None`` turns it on for few-step
        presets (``default_steps <= 8``) and logs that it did, as the JAX
        package does.  CLIP stays float."""
        import logging

        from sdtpu_torch.utils.quant import quantize_pipeline_int8

        if vae is None:
            vae = self.config.default_steps <= 8
            if vae:
                logging.getLogger("sdtpu_torch.pipeline").info(
                    "quantize_int8: few-step preset %s: the int8 VAE decoder path "
                    "is on (pass vae=False to leave it float)", self.config.name)
        self.params = quantize_pipeline_int8(self.params, vae=vae, **kw)
        return self

    def generate(
        self,
        prompt: str = "",
        negative_prompt: str = "",
        *,
        cfg: Optional[bool] = None,
        cfg_scale: Optional[float] = None,
        num_inference_steps: Optional[int] = None,
        seed: int = 0,
        image_size: Optional[int] = None,
        token_ids: Optional[np.ndarray] = None,
        sampler: Optional[str] = None,
        num_images: int = 1,
        latents: Optional[np.ndarray] = None,
        output: str = "uint8",
        clip_skip: int = 0,
        init_image=None,
        mask_image=None,
        control_image=None,
        prompt_weighting: bool = False,
        pag_scale: float = 0.0,
        freeu=None,
        encoder_cache_interval: int = 1,
        rng: str = "jax",
    ):
        """Text -> image.  ``token_ids`` bypasses the tokenizer (one cond row,
        or cond and uncond rows); ``latents`` (B, H/8, W/8, 4) replaces the
        drawn initial noise (scaled by the sampler's ``init_sigma`` as a
        drawn one is).  ``seed`` in [0, 2^32) draws the JAX package's
        latents and, for a stochastic sampler, per-step noise
        (``utils/prng.py``); ``rng="torch"`` draws the initial latents from
        ``torch.Generator().manual_seed(seed)`` (NCHW, then NHWC; txt2img
        only).  ``sampler``: a name of ``samplers.SAMPLERS`` (default the
        preset's).  ``output``:
        "uint8" (B, H, W, 3) numpy, "float" ([-1, 1] numpy), "latents", or
        "device": the uint8 images as a tensor on the device, returned
        without waiting for it (see :meth:`generate_async`)."""
        later = {
            "init_image": (init_image is not None, "img2img/inpainting slice"),
            "mask_image": (mask_image is not None, "img2img/inpainting slice"),
            "control_image": (control_image is not None, "ControlNet slice"),
            "prompt_weighting": (bool(prompt_weighting), "features slice"),
            "pag_scale": (pag_scale != 0.0, "features slice"),
            "freeu": (freeu is not None, "features slice"),
            "encoder_cache_interval": (encoder_cache_interval != 1, "features slice"),
            "num_images": (num_images != 1, "batching/serving slice (generate_batch)"),
        }
        for name, (used, where) in later.items():
            if used:
                raise NotImplementedError(f"generate({name}=...) belongs to the {where}")
        cfg = self.config.default_cfg if cfg is None else cfg
        cfg_scale = self.config.default_cfg_scale if cfg_scale is None else cfg_scale
        steps = self.config.default_steps if num_inference_steps is None else num_inference_steps
        sampler = sampler or self.config.default_sampler
        sdef = get_sampler(sampler)
        if steps < 1:
            raise ValueError("num_inference_steps must be >= 1")
        size = image_size or self.config.default_image_size
        f = self.config.vae.downscale_factor
        if size <= 0 or size % f:
            raise ValueError(f"image_size must be a positive multiple of {f}")
        if output not in OUTPUTS:
            raise ValueError(f"unknown output {output!r}")
        key = prng.key(seed)
        lat_hw = size // f
        if rng == "torch":
            if latents is not None:
                raise ValueError("rng='torch' is txt2img-only")
            g = torch.Generator().manual_seed(seed)
            latents = torch.randn((1, self.config.vae.latent_channels, lat_hw, lat_hw),
                                  generator=g).numpy().transpose(0, 2, 3, 1)
        elif rng != "jax":
            raise ValueError(f"unknown rng {rng!r} (expected 'jax' or 'torch')")
        schedule = sdef.make_schedule(self.config.scheduler, steps, device=self.device)
        # per-step variance noise only for a stochastic sampler, as the JAX
        # program splits its key per step only then
        n_noise = schedule.num_steps if sdef.stochastic else 0

        with stage("tokenize"):
            ids = self._tokenize(prompt, negative_prompt, cfg, token_ids)
        batch = ids.shape[0] // 2 if cfg else ids.shape[0]
        shape = (batch, lat_hw, lat_hw, self.config.vae.latent_channels)
        with stage("noise"):
            if latents is None:
                draws = request_noise(key, n_noise, shape, self.device, graphs=self._draws)
                lat0, noise = draws[0], draws[1:]
            else:
                lat0 = to_device(np.asarray(latents, np.float32), self.device)
                if lat0.ndim == 3:
                    lat0 = lat0[None]
                noise = (request_noise(key, n_noise, tuple(lat0.shape), self.device,
                                       init=False, graphs=self._draws) if n_noise else None)
        return self.txt2img(ids, lat0, noise if n_noise else None, cfg=cfg, cfg_scale=cfg_scale,
                            output=output, clip_skip=clip_skip, sampler=sampler,
                            schedule=schedule)

    def generate_async(self, prompt: str = "", negative_prompt: str = "",
                       **kwargs) -> "PendingImages":
        """Queue a generation without waiting for it: a :class:`PendingImages`
        whose ``result()`` fetches the uint8 images.  Dispatching request
        N+1 before fetching N keeps the card busy while the host prepares
        the next request::

            pending = pipe.generate_async(token_ids=ids, seed=0)
            for seed in range(1, n):
                nxt = pipe.generate_async(token_ids=ids, seed=seed)
                image = pending.result()   # N computes while N+1 is queued
                pending = nxt
        """
        if kwargs.get("output", "device") != "device":
            raise ValueError("generate_async implies output='device'")
        kwargs["output"] = "device"
        return PendingImages(self.generate(prompt, negative_prompt, **kwargs))

    def generate_batch(self, *args, **kwargs):
        raise NotImplementedError("generate_batch belongs to the batching/serving slice")

    @torch.inference_mode()
    def txt2img(self, ids, latents: torch.Tensor, noise: Optional[torch.Tensor], *, cfg: bool,
                cfg_scale: float, output: str = "uint8", clip_skip: int = 0,
                sampler: str = "ddpm", steps: Optional[int] = None, schedule=None):
        """The whole request with its noise given: ``ids`` (rows, L) token
        ids (``[cond..., uncond...]`` under CFG), ``latents`` (B, h, w, 4)
        float32 N(0, 1) initial noise (scaled here by the schedule's
        ``init_sigma``), ``noise`` (steps, B, h, w, 4) float32 variance
        noise, one slice per step, for a stochastic sampler (None for a
        deterministic one).  ``steps`` defaults to ``noise``'s length;
        ``schedule`` to ``sampler``'s for ``steps``.  ``generate`` draws
        both as the JAX package does; a caller may pass any."""
        cdt = self.config.compute_dtype
        sdef = get_sampler(sampler)
        if schedule is None:
            if steps is None:
                if noise is None:
                    raise ValueError("txt2img: pass steps= or the per-step noise")
                steps = noise.shape[0]
            schedule = sdef.make_schedule(self.config.scheduler, steps, device=self.device)
        if sdef.stochastic and (noise is None or noise.shape[0] != schedule.num_steps):
            raise ValueError(f"sampler {sampler!r} takes one noise slice per step "
                             f"({schedule.num_steps})")
        with stage("clip"):
            ids = to_device(np.asarray(ids, np.int64), self.device)
            hidden, _ = clip_encode_windows(ids, self.params["clip"], self.config.clip,
                                            clip_skip=clip_skip)
            context = hidden.to(cdt)
        lat = latents.float()
        if hasattr(schedule, "init_sigma"):  # sigma-space samplers start at sigma_max
            lat = lat * schedule.init_sigma
        lat = self.denoise(context, lat, noise, schedule, cfg=cfg, cfg_scale=cfg_scale,
                           sampler=sampler)
        if output == "latents":
            return lat.float().cpu().numpy()
        with stage("vae_decode"):
            img = vae_decode(lat.to(cdt), self.params["vae_decoder"], self.config.vae,
                             attention_impl=self.attention_impl,
                             conv_impl=self.conv_impl).float()
        if output == "float":
            return img.cpu().numpy()
        with stage("to_uint8"):
            img = to_uint8(img)
        return img if output == "device" else img.cpu().numpy()

    def denoise(self, context, latents, noise, schedule, *, cfg: bool, cfg_scale: float,
                sampler: str = "ddpm"):
        """The sampler's loop; ``context`` is (2B, L, D) under CFG, else
        (B, L, D); ``noise`` (steps, B, h, w, 4) for a stochastic sampler,
        else None."""
        ucfg = self.config.unet
        unet = self.params["unet"]
        cdt = self.config.compute_dtype
        batch = latents.shape[0]
        model_batch = 2 * batch if cfg else batch
        with stage("precompute"):
            cross_kv = precompute_cross_kv(context, unet, ucfg)
            time_cache = precompute_time_projections(
                schedule.timesteps, unet, ucfg, batch=model_batch, dtype=cdt)
        sdef = get_sampler(sampler)
        state = sdef.state_init(latents) if sdef.multistep else None
        lat = latents
        for i in range(schedule.num_steps):
            with stage("unet_step"):
                lat_in = torch.cat([lat, lat]) if cfg else lat
                if sdef.scale_model_input is not None:
                    lat_in = sdef.scale_model_input(schedule, i, lat_in)
                eps = unet_forward(
                    lat_in.to(cdt), schedule.timesteps[i], context, unet, ucfg,
                    attention_impl=self.attention_impl, conv_impl=self.conv_impl,
                    cross_kv=cross_kv, time_cache=time_cache_step(time_cache, i),
                ).float()
                if cfg:
                    cond, uncond = eps[:batch], eps[batch:]
                    eps = uncond + cfg_scale * (cond - uncond)
                z = noise[i] if sdef.stochastic else None
                if sdef.multistep:
                    lat, state = sdef.step(schedule, i, lat, eps, z, state)
                else:
                    lat = sdef.step(schedule, i, lat, eps, z)
        return lat

    def _uncond_row(self) -> np.ndarray:
        """BOS then EOS padding: the empty prompt's row for CFG's
        unconditional branch when only the cond row was given."""
        vocab = self.config.text_config.vocab_size
        row = np.full((self.config.text_config.max_length,), vocab - 1, dtype=np.int64)
        row[0] = vocab - 2
        return row

    def _tokenize(self, prompt, negative_prompt, cfg, token_ids) -> np.ndarray:
        max_len = self.config.text_config.max_length
        if token_ids is not None:
            ids = np.asarray(token_ids)
            if ids.ndim == 1:
                ids = ids[None]
        else:
            if self.tokenizer is None:
                raise ValueError("no tokenizer installed: pass token_ids")
            texts = [prompt] + ([negative_prompt] if cfg else [])
            enc = [self.tokenizer.encode_long(t, window=max_len) for t in texts]
            n = max(len(e) // max_len for e in enc)
            ids = np.asarray([
                e if len(e) == n * max_len
                else self.tokenizer.encode_long(t, window=max_len, num_windows=n)
                for e, t in zip(enc, texts)
            ])
        if cfg and ids.shape[0] == 1:
            n = ids.shape[1] // max_len
            if self.tokenizer is not None:
                neg = self.tokenizer.encode_long(negative_prompt, window=max_len,
                                                 num_windows=n)
                ids = np.concatenate([ids, np.asarray(neg)[None]], axis=0)
            else:
                ids = np.concatenate([ids, np.tile(self._uncond_row(), n)[None]], axis=0)
        return np.asarray(ids, dtype=np.int32)
