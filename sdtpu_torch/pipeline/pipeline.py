"""Text-to-image and image-conditioned pipeline.

Counterpart of ``sdtpu/pipeline/pipeline.py`` for txt2img and img2img with
classifier-free guidance and any of the JAX package's 13 samplers
(``samplers/__init__.py``), one request (``generate``) or a batch of them
(``generate_batch``, which the serving engine in ``serving.py`` drives).
The JAX package compiles the whole request into one program; here it runs
eagerly, in the same order:

1. CLIP on the token rows, ordered ``[cond..., uncond...]`` under CFG;
   for SDXL both encoders (CLIP-L's and bigG's penultimate states
   concatenated, or bigG's alone for the refiner) with bigG's pooled
   projection and the size/crop (or aesthetic-score) time ids as the
   UNet's add-embedding inputs;
2. for an init image, the VAE encoder: img2img forward-noises the encoded
   latents to the schedule's first step, latent-blend inpainting also
   keeps them to paste back after each step, a 9-channel inpaint UNet
   takes the mask and the masked image's latents as extra channels, and an
   InstructPix2Pix (8-channel) UNet the image's unscaled posterior mode;
3. the cross-attention K/V of every transformer block and every time
   projection of every step (with an LCM UNet's guidance embedding and
   SDXL's add-embedding folded in), computed once before the loop;
4. per step: the latents repeated for the guidance branches -> the
   sampler's ``scale_model_input`` -> the extra channels -> ``unet_forward``
   -> the guidance combine -> the sampler's step (a stochastic one with
   that step's noise, a multistep one with its state) -> the inpaint blend;
   on a card the plain ``unet_forward`` of a step replays a CUDA graph
   captured once per shape (``unet_graphs.py``; not for ControlNet, the
   encoder cache's grouped steps, a tp mesh or int8 calibration), and the
   rest of the step runs eagerly around it;
5. ``vae_decode`` and the uint8 conversion, on the device.

A request's draws are the JAX program's (``request_keys``): a scalar key
``key(uint32(seed))`` splits once per draw, in the program's order; per-
request keys (``generate_batch(seeds=...)``, one per row) fold in a salt
per draw instead, so a row's image does not depend on its batch.  All of
a request's draws run in one batched call before the loop, on the device
(on a card as one replayed CUDA graph).  ``rng="torch"`` draws the initial
latents from a CPU ``torch.Generator`` instead.  ``txt2img`` and
``img2img`` take the draws as explicit tensors.

``from_pretrained`` loads a local diffusers checkpoint directory
(``utils/weights.py:load_pipeline_params``).  ``denoising_end`` /
``denoising_start`` split the schedule for the SDXL base -> refiner
handoff (``samplers.slice_schedule``).

The denoise step's features: one or several ControlNets
(``load_controlnet``; each net's cond embedding, cross K/V and time
projections once before the loop, its residuals summed into the UNet's
skips every step), Perturbed-Attention Guidance (a third branch, rows
``[cond, (uncond,) perturbed]``, identity self-attention on its rows at the
PAG site), FreeU, CFG rescale (:func:`rescale_noise_cfg`) and the encoder
cache (the UNet's encoder once per group of k steps, the decoder every
step).  ``generate_hires`` chains a txt2img request and an img2img one.

The text features: LoRA adapters fused into the weights (``load_lora``,
``unload_loras``: the same kernels at the same shapes), textual-inversion
rows appended to the token tables (``load_textual_inversion``), and
weighted prompts (``prompt_weighting``, ``token_weights``: each encoder's
states scaled per token, :func:`apply_token_weights`).

Each stage runs inside ``utils/profiling.stage``: ``tokenize``, ``noise``,
``clip``, ``vae_encode``, ``precompute``, ``unet_step`` (once per step, its
attribute ``graph`` "eager", "capture" or "replay"), ``vae_decode``,
``to_uint8``; and so do the host stretches between them:
``request`` around each ``generate``/``generate_batch`` call (a call inside
another joins its span), ``prepare`` (the feature checks, the per-row keys,
the images, masks and control maps on the host) and ``upload`` (the
schedule, and the images and masks on the device).  With ``output="device"`` a
request makes no host sync between its tokens and the returned tensor.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch

from sdtpu_torch.config import PipelineConfig, get_preset
from sdtpu_torch.models.clip import clip_encode_windows
from sdtpu_torch.models.controlnet import controlnet_cond_embed, controlnet_forward
from sdtpu_torch.models.unet import (
    precompute_cross_kv,
    precompute_time_projections,
    time_cache_step,
    unet_decode,
    unet_encode,
    unet_forward,
)
from sdtpu_torch.models.vae import vae_decode, vae_encode
from sdtpu_torch.ops.resize import resize_image
from sdtpu_torch.ops.embedding import timestep_embedding
from sdtpu_torch.parallel.mesh import Mesh, sharded_mesh, tp_context
from sdtpu_torch.pipeline.unet_graphs import UNetGraphs, graph_key, graph_route
from sdtpu_torch.samplers import get_sampler, slice_schedule
from sdtpu_torch.utils import prng, profiling
from sdtpu_torch.utils.image import from_uint8, to_uint8
from sdtpu_torch.utils.profiling import stage
from sdtpu_torch.utils.runtime import to_device

OUTPUTS = ("uint8", "float", "latents", "device")

# The draws a program makes before its steps' noise
# (sdtpu/pipeline/pipeline.py:1919-1934, 1972-1978, 2051-2067): none when
# the caller injects the initial latents, the initial latents for txt2img,
# the encoder's posterior noise and the forward noise for img2img (and
# InstructPix2Pix, which draws both and starts from the forward noise),
# and the masked image's encoder noise after them for a 9-channel inpaint
# UNet.
PROGRAMS = {
    "latents": (),
    "txt2img": ("init",),
    "img2img": ("enc", "fwd"),
    "inpaint": ("enc", "fwd", "masked"),
}
# Under per-request keys each draw folds a salt into the row's key: these,
# and 2 + i for step i's noise (:1769).  The JAX program's comment calls
# the salts disjoint; they are not: step 1's noise (salt 3) equals the
# masked image's encoder noise of a 9-channel inpaint UNet (same salt,
# same shape), and the port reproduces it.
SALTS = {"init": 0, "enc": 0, "fwd": 1, "masked": 3}
STEP_SALT = 2


def request_keys(key, steps: int, *, program: str = "txt2img") -> np.ndarray:
    """The keys of a request's draws, in the JAX program's order: first
    ``PROGRAMS[program]``'s, then one per step (variance noise).

    A scalar key ((2,) uint32) splits as the program does: txt2img
    ``key, k_init = split(key)``; img2img ``key, k_enc, k_fwd =
    split(key, 3)``, then for a 9-channel inpaint UNet ``key, k_m =
    split(key)``; then each step's ``key, sub = split(key)``.  Returns
    (n, 2).  Per-request keys ((B, 2), one per row) fold in ``SALTS`` and
    ``STEP_SALT + i``.  Returns (n, B, 2)."""
    heads = PROGRAMS[program]
    key = np.asarray(key, np.uint32)
    if key.ndim == 2:
        salts = [SALTS[h] for h in heads] + [STEP_SALT + i for i in range(steps)]
        return np.asarray([[prng.fold_in(k, s) for k in key] for s in salts],
                          np.uint32).reshape(len(salts), key.shape[0], 2)
    keys = []
    if heads == ("init",):
        key, k_init = prng.split(key)
        keys.append(k_init)
    elif heads:
        key, k_enc, k_fwd = prng.split(key, 3)
        keys += [k_enc, k_fwd]
        if "masked" in heads:
            key, k_m = prng.split(key)
            keys.append(k_m)
    for _ in range(steps):
        key, sub = prng.split(key)
        keys.append(sub)
    return np.asarray(keys, np.uint32).reshape(len(keys), 2)


def request_noise(key, steps: int, shape, device, *, program: str = "txt2img",
                  graphs: Optional[prng.NormalGraphs] = None) -> torch.Tensor:
    """The normals of :func:`request_keys`, (n, *shape) float32 on
    ``device``, ``shape`` = (B, h, w, c): a scalar key draws each at
    ``shape``, per-request keys each row at ``shape[1:]``.  One batched
    call: by numpy on the CPU (``prng.normal``), by torch on a card
    (``prng.normal_torch``), through ``graphs`` (its CUDA graph replayed)
    where given."""
    keys = request_keys(key, steps, program=program)
    shape = tuple(shape)
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((0, *shape), device=device)
    draw = shape[1:] if keys.ndim == 3 else shape
    flat = keys.reshape(-1, 2)
    if torch.device(device).type == "cpu":
        out = torch.from_numpy(np.stack([prng.normal(k, draw) for k in flat]))
    elif graphs is not None:
        out = graphs(flat, draw, device)
    else:
        out = prng.normal_torch(flat, draw, device)
    return out.reshape(n, *shape)


def _request_span(fn):
    """Run a pipeline call inside a ``request`` span with a fresh request
    id, or inside the enclosing call's (``generate(num_images=n)`` runs
    ``generate_batch``)."""

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        if profiling.in_span("request"):
            return fn(self, *args, **kwargs)
        with stage("request", requests=(profiling.new_request_id(),)):
            return fn(self, *args, **kwargs)

    return call


def rescale_noise_cfg(eps_cfg: torch.Tensor, eps_text: torch.Tensor, rescale: float):
    """CFG rescale (Lin et al. 2023, eq. 16; diffusers ``guidance_rescale``):
    the combined prediction scaled to the text branch's per-row standard
    deviation (over all axes but the batch, float32, divided by n as
    ``jnp.std``), blended with the unscaled one by ``rescale``; a row whose
    combined deviation is 0 keeps factor 1."""
    dims = tuple(range(1, eps_cfg.ndim))
    std_text = torch.std(eps_text.float(), dim=dims, keepdim=True, correction=0)
    std_cfg = torch.std(eps_cfg, dim=dims, keepdim=True, correction=0)
    factor = torch.where(std_cfg > 0.0, std_text / std_cfg, torch.ones_like(std_cfg))
    return rescale * (eps_cfg * factor) + (1.0 - rescale) * eps_cfg


def check_features(encoder_cache_interval, has_control, guidance_rescale, pag_scale, freeu,
                   cfg, is_edit, control_rows=None, controlnet_loaded=True) -> dict:
    """The JAX package's checks of the encoder cache, of ``generate_batch``'s
    control maps (``control_rows``: the maps' and the prompts' counts), of
    CFG rescale, PAG and FreeU, in its order and with its messages; returns
    the denoise loop's feature arguments (FreeU's factors as a tuple of
    floats)."""
    if encoder_cache_interval < 1:
        raise ValueError("encoder_cache_interval must be >= 1")
    if encoder_cache_interval > 1 and has_control:
        raise ValueError("encoder_cache_interval is incompatible with ControlNet "
                         "(the control residuals enter the cached encoder half)")
    if control_rows is not None:
        if not controlnet_loaded:
            raise ValueError("control_images requires a ControlNet — call "
                             "pipe.load_controlnet(...) first")
        if control_rows[0] != control_rows[1]:
            raise ValueError("control_images must match the number of prompts")
    if guidance_rescale != 0.0:
        if not 0.0 < guidance_rescale <= 1.0:
            raise ValueError("guidance_rescale must be in [0, 1]")
        if not cfg:
            raise ValueError("guidance_rescale rescales the CFG combine — it needs cfg=True")
        if is_edit:
            raise ValueError("guidance_rescale is not defined for editing checkpoints "
                             "(InstructPix2Pix uses 3-branch guidance)")
    if pag_scale != 0.0:
        if pag_scale < 0.0:
            raise ValueError("pag_scale must be >= 0")
        if is_edit:
            raise ValueError("pag_scale is incompatible with editing checkpoints "
                             "(InstructPix2Pix's 3-branch guidance owns the extra rows)")
    if freeu is not None:
        try:
            freeu = tuple(round(float(v), 6) for v in freeu)
            if len(freeu) != 4:
                raise ValueError
        except (TypeError, ValueError):
            raise ValueError("freeu must be (b1, b2, s1, s2) — e.g. (1.5, 1.6, 0.9, 0.2) "
                             "for SD 1.x, (1.3, 1.4, 0.9, 0.2) for SDXL") from None
    return dict(guidance_rescale=guidance_rescale, pag_scale=pag_scale, freeu=freeu,
                encoder_cache_interval=encoder_cache_interval)


class PendingImages:
    """An in-flight :meth:`StableDiffusionPipeline.generate_async` result:
    the uint8 images as a device tensor whose work may still be queued.
    ``result()`` waits for it and copies it to the host."""

    __slots__ = ("device_images",)

    def __init__(self, device_images: torch.Tensor):
        self.device_images = device_images

    def result(self) -> np.ndarray:
        return self.device_images.cpu().numpy()


def apply_token_weights(hidden: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Each token's encoded states ``hidden`` (rows, L, D) scaled by its
    weight ``tw`` (rows, L), then renormalized so that a row's mean
    magnitude mean(|h|) stays what it was (the JAX package's
    ``apply_token_weights``, ``sdtpu/pipeline/pipeline.py:1476``).

    The weighted statistic is ``prev + mean(|h| (|w| - 1))``, not a second
    mean(|h w|): with w == 1 the added term is exactly zero, the ratio
    exactly 1, and unit weights give the unweighted states bitwise."""
    h32 = hidden.float()
    w = tw[..., None]
    habs = h32.abs()
    prev = habs.mean(dim=(-2, -1), keepdim=True)
    new_mean = prev + (habs * (w.abs() - 1.0)).mean(dim=(-2, -1), keepdim=True)
    one = torch.ones_like(prev)
    ratio = torch.where(new_mean == 0.0, one, prev / new_mean)
    ratio = torch.where(prev == new_mean, one, ratio)
    return (h32 * w * ratio).to(hidden.dtype)


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
        # the denoise steps' UNet forwards as CUDA graphs (unet_graphs.py),
        # dropped whenever ``params`` is assigned
        self._unet_graphs = UNetGraphs()
        self.params = params
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        # a ControlNet tree, or a list of them (load_controlnet)
        self.controlnet = None
        # a request's draws on a card: one CUDA graph replay per request
        self._draws = prng.NormalGraphs() if self.device.type == "cuda" else None
        # load_lora's pre-fuse kernels, first write wins per module
        self._lora_originals = {}

    @property
    def params(self) -> dict:
        """The parameter tree.  Assigning it drops the captured UNet graphs,
        which hold pointers to the old tree's weights."""
        return self._params

    @params.setter
    def params(self, tree) -> None:
        self._params = tree
        self._unet_graphs.clear()

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
        ``tokenizer_2/`` (a bigG-only refiner ships only that one), then
        the repository's default assets."""
        import os

        from sdtpu_torch.config import PRESETS, config_from_checkpoint
        from sdtpu_torch.tokenizer.bpe import CLIPTokenizer
        from sdtpu_torch.utils.weights import load_pipeline_params

        if preset is not None:
            config = get_preset(preset)
        else:
            base = os.path.basename(model_dir.rstrip("/"))
            config = get_preset(base) if base in PRESETS else config_from_checkpoint(model_dir)
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
        self._refuse_sharded("quantize_int8")
        self.params = quantize_pipeline_int8(self.params, vae=vae, **kw)
        return self

    def load_controlnet(self, controlnet) -> "StableDiffusionPipeline":
        """Attach a ControlNet for ``control_image=`` (:meth:`generate`) and
        ``control_images=`` (:meth:`generate_batch`); returns self.
        ``controlnet``: a diffusers ``ControlNetModel`` safetensors file or
        model directory (read against this pipeline's UNet config, in its
        ``param_dtype``), a tree (``models/controlnet.py:init_controlnet``,
        or the JAX package's tree as numpy arrays, each leaf keeping its
        dtype), or a list of either: multi-ControlNet, one control map per
        net, the residuals summed, one scale per net or one for all.  The
        tree stays float on an int8 pipeline, as in the JAX package.  A tree
        from ``shard_params_tp`` is kept as it is."""
        from sdtpu_torch.utils.weights import load_controlnet_params, params_from_numpy

        def load_one(cn):
            if sharded_mesh(cn) is not None:  # shard_params_tp's tree, on its device
                return cn
            if isinstance(cn, str):
                return load_controlnet_params(cn, self.config.unet,
                                              dtype=self.config.param_dtype, device=self.device)
            return params_from_numpy(cn, device=self.device)

        if isinstance(controlnet, (list, tuple)):
            self.controlnet = [load_one(c) for c in controlnet]
        else:
            self.controlnet = load_one(controlnet)
        return self

    def _controlnets(self) -> list:
        """The loaded ControlNet(s) as a list."""
        return (list(self.controlnet) if isinstance(self.controlnet, (list, tuple))
                else [self.controlnet])

    @staticmethod
    def _control_args(nets, control_image, controlnet_scale):
        """(control map(s), scale(s)) against the loaded nets: (list of maps,
        list of float scales), one per net."""
        imgs = list(control_image) if isinstance(control_image, (list, tuple)) else [control_image]
        if len(imgs) != len(nets):
            raise ValueError(f"{len(nets)} ControlNet(s) loaded but {len(imgs)} control "
                             "image(s) given — multi-ControlNet needs one map per net")
        scales = (list(controlnet_scale) if isinstance(controlnet_scale, (list, tuple))
                  else [controlnet_scale] * len(nets))
        if len(scales) != len(nets):
            raise ValueError("controlnet_scale list must match the number of ControlNets")
        return imgs, [float(s) for s in scales]

    def _control_rows(self, entries, controlnet_scale, size) -> list:
        """One control entry per request row (a map, or one map per net) ->
        :meth:`denoise`'s ``control``: [(net, (rows, size, size, 3) maps,
        scale)], the scales the first row's."""
        nets = self._controlnets()
        rows = [self._control_args(nets, entry, controlnet_scale) for entry in entries]
        return [(net, np.concatenate([self._prep_control(r[0][k], size) for r in rows]),
                 rows[0][1][k]) for k, net in enumerate(nets)]

    def load_lora(self, lora, *, scale: float = 1.0) -> dict:
        """Fuse a LoRA adapter into the weights (``utils/lora.py``: kohya or
        diffusers-peft keys) and return the report: ``applied`` modules,
        ``skipped`` names, ``unrecognized`` keys.  ``lora``: a safetensors
        path (read by the port's reader) or a mapping of names to tensors
        or arrays; ``scale``: the adapter's strength.  A fused request runs
        the same kernels at the same shapes as the base one; adapters stack
        by repeated calls.  Fuse before :meth:`quantize_int8` (an int8 leaf
        raises).

        The pre-fuse kernel of each touched module (first load wins) is kept
        for :meth:`unload_loras` on the leaf's own device, in its dtype, as
        the replaced tensor itself (a clone of the row for a stacked CLIP
        leaf): as many bytes as the adapted kernels themselves (for an
        adapter over every module, about the UNet's and CLIP's kernels
        again), held until :meth:`unload_loras`."""
        from sdtpu_torch.utils.lora import apply_lora
        from sdtpu_torch.utils.weights import load_safetensors

        self._refuse_sharded("load_lora")
        sd = load_safetensors(lora) if isinstance(lora, str) else lora
        self.params, report = apply_lora(self.params, sd, scale=scale)
        for key, orig in report.pop("originals").items():
            self._lora_originals.setdefault(key, orig)
        return report

    def unload_loras(self) -> int:
        """Remove every fused adapter, putting back the pre-fuse kernels that
        :meth:`load_lora` kept (bitwise the tree before the first load);
        returns the number of modules restored, 0 when none is loaded."""
        if not self._lora_originals:
            return 0
        from sdtpu_torch.utils.lora import restore_weights

        self.params = restore_weights(self.params, self._lora_originals)
        n = len(self._lora_originals)
        self._lora_originals = {}
        return n

    def load_textual_inversion(self, embeds, *, token: Optional[str] = None) -> dict:
        """Append textual-inversion vectors to the token table(s)
        (``utils/textual_inversion.py``) and register each placeholder with
        the tokenizer, when one is installed, so that prompts can use it (a
        multi-vector concept expands to one id per vector).  ``embeds``: a
        safetensors path or a mapping; ``token`` names the placeholder of
        the ``emb_params`` and dual-encoder layouts.  Returns
        ``{placeholder: [token ids]}``, which a ``token_ids`` caller splices
        in itself."""
        from sdtpu_torch.utils.textual_inversion import apply_textual_inversion
        from sdtpu_torch.utils.weights import load_safetensors

        self._refuse_sharded("load_textual_inversion")
        sd = load_safetensors(embeds) if isinstance(embeds, str) else embeds
        self.params, registered = apply_textual_inversion(self.params, sd, token=token)
        if self.tokenizer is not None:
            for placeholder, ids in registered.items():
                self.tokenizer.add_placeholder(placeholder, ids)
        return registered

    # -- public API -----------------------------------------------------------

    @_request_span
    def generate(
        self,
        prompt: str = "",
        negative_prompt: str = "",
        *,
        strength: float = 0.9,
        cfg: Optional[bool] = None,
        cfg_scale: Optional[float] = None,
        num_inference_steps: Optional[int] = None,
        seed: int = 0,
        init_image: Optional[np.ndarray] = None,
        mask_image: Optional[np.ndarray] = None,
        image_size: Optional[int] = None,
        token_ids: Optional[np.ndarray] = None,
        sampler: Optional[str] = None,
        num_images: int = 1,
        latents: Optional[np.ndarray] = None,
        rng: str = "jax",
        output: str = "uint8",
        clip_skip: int = 0,
        prompt_weighting: bool = False,
        token_weights: Optional[np.ndarray] = None,
        control_image=None,
        controlnet_scale=1.0,
        image_guidance_scale: float = 1.5,
        guidance_rescale: float = 0.0,
        pag_scale: float = 0.0,
        freeu=None,
        encoder_cache_interval: int = 1,
        denoising_end: Optional[float] = None,
        denoising_start: Optional[float] = None,
    ):
        """Text -> image, or image -> image when ``init_image`` is given.

        ``init_image`` ((H, W, 3) uint8, or floats in [-1, 1]; resized to
        the request's size by nearest neighbour) is VAE-encoded and
        forward-noised to ``strength`` in (0, 1] of the schedule.
        ``mask_image`` (with ``init_image``; (H, W[, C]), white / 1.0 =
        repaint) inpaints: with a 4-channel UNet the preserved region is
        pasted back after each step (forward-noised to the step the carry is
        at, the clean latents after the last), with a 9-channel inpaint
        UNet the mask and the masked image's latents ride as extra input
        channels (a pure-noise start at ``strength`` 1).  An 8-channel
        InstructPix2Pix UNet edits ``init_image`` with three guidance
        branches [text+image, image, unconditional] steered by
        ``cfg_scale`` and ``image_guidance_scale``; it ignores
        ``strength``.  ``num_images > 1`` runs :meth:`generate_batch` with
        seeds ``seed + i`` (``latents`` and ``rng`` are ignored there, as
        the JAX package ignores them).

        ``token_ids`` bypasses the tokenizer (one cond row, or cond and
        uncond rows).  ``prompt_weighting`` parses ``(word:1.3)`` /
        ``[word]`` emphasis in both prompts (``utils/prompt_weighting.py``;
        needs the tokenizer) and scales each token's encoded states by its
        weight, renormalized to the row's unweighted mean magnitude
        (:func:`apply_token_weights`); ``token_weights`` is the same for
        ``token_ids``, one float per id (rows it does not cover weigh 1).
        ``latents`` (B, H/8, W/8, 4) replaces the drawn
        initial noise (scaled by the sampler's ``init_sigma`` as a drawn
        one is; txt2img only).  ``seed`` in [0, 2^32) draws the JAX
        package's latents and noise (``utils/prng.py``); ``rng="torch"``
        draws the initial latents from ``torch.Generator().manual_seed(
        seed)`` (NCHW, then NHWC; txt2img only).  ``sampler``: a name of
        ``samplers.SAMPLERS`` (default the preset's).  ``output``: "uint8"
        (B, H, W, 3) numpy, "float" ([-1, 1] numpy), "latents", or
        "device": the uint8 images as a tensor on the device, returned
        without waiting for it (see :meth:`generate_async`).

        ``denoising_end`` / ``denoising_start``: the SDXL base -> refiner
        handoff (diffusers semantics: the schedule splits at the training
        timestep ``round(N - frac * N)``).  The base runs the high-noise
        head and returns its carry (``denoising_end=0.8,
        output="latents"``); the refiner takes it (``latents=...,
        denoising_start=0.8``) as it is, with no ``init_sigma`` scaling,
        and runs the low-noise tail.  With one model and a deterministic
        sampler a split run equals the unsplit one.

        ``control_image`` (after :meth:`load_controlnet`): an (H, W[, 1|3])
        uint8 or [0, 1] float control map, one per net for several nets;
        ``controlnet_scale`` (one, or one per net) multiplies the residuals.
        ``pag_scale`` > 0: Perturbed-Attention Guidance, eps = uncond +
        cfg_scale (cond - uncond) + pag_scale (cond - perturbed), or cond +
        pag_scale (cond - perturbed) without CFG.  ``freeu``: (b1, b2, s1,
        s2).  ``guidance_rescale`` in (0, 1]: CFG rescale
        (:func:`rescale_noise_cfg`).  ``encoder_cache_interval`` k > 1: the
        UNet's encoder once per group of k steps, the decoder alone with the
        step's time projections in between, a ``steps % k`` remainder in
        full at the end; not with ControlNet."""
        cfg = self.config.default_cfg if cfg is None else cfg
        cfg_scale = self.config.default_cfg_scale if cfg_scale is None else cfg_scale
        steps = self.config.default_steps if num_inference_steps is None else num_inference_steps
        sampler = sampler or self.config.default_sampler
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        if steps < 1:
            raise ValueError("num_inference_steps must be >= 1")
        size = self._size(image_size)
        if denoising_start is not None:
            if latents is None:
                raise ValueError(
                    "denoising_start consumes a base model's latents — pass "
                    "latents= (base run: denoising_end=..., output='latents')")
            if not 0.0 < denoising_start < 1.0:
                raise ValueError("denoising_start must be in (0, 1)")
        if denoising_end is not None and not 0.0 < denoising_end < 1.0:
            raise ValueError("denoising_end must be in (0, 1)")
        if num_images > 1 and (denoising_end is not None or denoising_start is not None):
            raise ValueError("denoising_end/denoising_start are single-image (the "
                             "base->refiner handoff carries explicit latents)")
        if num_images > 1:
            return self.generate_batch(
                [prompt] * num_images, negative_prompt, cfg=cfg, cfg_scale=cfg_scale,
                num_inference_steps=steps, seeds=[seed + i for i in range(num_images)],
                image_size=image_size,
                token_ids=(np.tile(np.asarray(token_ids)[:1], (num_images, 1))
                           if token_ids is not None else None),
                sampler=sampler,
                init_images=[init_image] * num_images if init_image is not None else None,
                mask_images=[mask_image] * num_images if mask_image is not None else None,
                strength=strength, output=output, clip_skip=clip_skip,
                prompt_weighting=prompt_weighting,
                token_weights=(np.tile(np.asarray(token_weights, np.float32).reshape(1, -1),
                                       (num_images, 1)) if token_weights is not None else None),
                control_images=([control_image] * num_images
                                if control_image is not None else None),
                controlnet_scale=controlnet_scale,
                image_guidance_scale=image_guidance_scale, guidance_rescale=guidance_rescale,
                pag_scale=pag_scale, freeu=freeu,
                encoder_cache_interval=encoder_cache_interval)
        weights = None
        with stage("tokenize"):
            ids = self._tokenize(prompt, negative_prompt, cfg, token_ids,
                                 weighted=prompt_weighting)
            if prompt_weighting:
                ids, weights = ids
            elif token_weights is not None:
                if token_ids is None:
                    raise ValueError("token_weights requires token_ids")
                tw = np.asarray(token_weights, np.float32)
                if tw.ndim == 1:
                    tw = tw[None]
                # the rows it does not cover (a synthesized uncond) weigh 1
                weights = np.ones(ids.shape, np.float32)
                weights[:tw.shape[0]] = tw
        is_img2img = init_image is not None
        if mask_image is not None and not is_img2img:
            raise ValueError("mask_image requires init_image (inpainting)")
        is_edit = is_img2img and self._is_edit()
        if is_edit and mask_image is not None:
            raise ValueError("editing checkpoints (InstructPix2Pix) take no mask")
        if rng == "torch":
            if is_img2img or latents is not None:
                raise ValueError("rng='torch' is txt2img-only")
            g = torch.Generator().manual_seed(seed)
            lat_hw = size // self.config.vae.downscale_factor
            latents = torch.randn((1, self.config.vae.latent_channels, lat_hw, lat_hw),
                                  generator=g).numpy().transpose(0, 2, 3, 1)
        elif rng != "jax":
            raise ValueError(f"unknown rng {rng!r} (expected 'jax' or 'torch')")
        if latents is not None and is_img2img:
            raise ValueError("latents injection is txt2img-only")
        has_control = control_image is not None
        if has_control and self.controlnet is None:
            raise ValueError("control_image requires a ControlNet — call "
                             "pipe.load_controlnet(...) first")
        with stage("prepare"):
            features = check_features(encoder_cache_interval, has_control, guidance_rescale,
                                      pag_scale, freeu, cfg, is_edit)
            if latents is not None:
                latents = np.asarray(latents, np.float32)
                if latents.ndim == 3:
                    latents = latents[None]
            key = prng.key(seed)
            images = self._prep_image(init_image, size) if is_img2img else None
            masks = self._prep_mask(mask_image, size) if mask_image is not None else None
            control = (self._control_rows([control_image], controlnet_scale, size)
                       if has_control else None)
        return self._request(
            ids, key, size=size, steps=steps, cfg=cfg, cfg_scale=cfg_scale,
            sampler=sampler, strength=strength, image_guidance_scale=image_guidance_scale,
            images=images, masks=masks, latents=latents, output=output, clip_skip=clip_skip,
            token_weights=weights, denoising_end=denoising_end,
            denoising_start=denoising_start, control=control, **features)

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

    def generate_hires(self, prompt: str = "", negative_prompt: str = "", *,
                       image_size: Optional[int] = None, base_size: Optional[int] = None,
                       hires_strength: float = 0.7, **kwargs):
        """The two-pass hires fix: txt2img at ``base_size`` (default half the
        target, a multiple of 8, at least 64), a bilinear upscale of the
        float image on the host (``utils/image.py:bilinear_resize``), then
        img2img at ``image_size`` with ``hires_strength``.  The other
        :meth:`generate` arguments apply to both passes, ``output`` to the
        second; ``init_image``, ``mask_image`` and ``latents`` belong to
        the method.  With ``num_images`` > 1 the second pass runs once per
        row, with ``seed + i``."""
        from sdtpu_torch.utils.image import bilinear_resize

        size = image_size or self.config.default_image_size
        if base_size is None:
            base_size = max(64, (size // 2) // 8 * 8)
        if base_size % 8 or size % 8:
            raise ValueError("image_size/base_size must be multiples of 8")
        if base_size >= size:
            raise ValueError("base_size must be smaller than image_size")
        for owned in ("init_image", "mask_image", "latents"):
            if kwargs.pop(owned, None) is not None:
                raise ValueError(f"generate_hires owns {owned}")
        kwargs.pop("strength", None)  # the second pass takes hires_strength
        output = kwargs.pop("output", "uint8")
        num_images = int(kwargs.pop("num_images", 1) or 1)
        if num_images > 1 and output == "device":
            raise ValueError("generate_hires(num_images>1) fetches per-row results; use "
                             "output='uint8' or 'float'")
        base = self.generate(prompt, negative_prompt, image_size=base_size, output="float",
                             num_images=num_images, **kwargs)
        up = bilinear_resize(np.asarray(base), size, size)
        if num_images == 1:
            return self.generate(prompt, negative_prompt, image_size=size, init_image=up,
                                 strength=hires_strength, output=output, **kwargs)
        seed = kwargs.pop("seed", 0)
        outs = [self.generate(prompt, negative_prompt, image_size=size, init_image=up[i:i + 1],
                              strength=hires_strength, output=output, seed=seed + i, **kwargs)
                for i in range(num_images)]
        return np.concatenate([np.asarray(o) for o in outs], axis=0)

    @_request_span
    def generate_batch(
        self,
        prompts,
        negative_prompt="",
        *,
        cfg: Optional[bool] = None,
        cfg_scale: Optional[float] = None,
        num_inference_steps: Optional[int] = None,
        seed: int = 0,
        seeds=None,
        image_size: Optional[int] = None,
        token_ids: Optional[np.ndarray] = None,
        sampler: Optional[str] = None,
        init_images=None,
        mask_images=None,
        strength: float = 0.9,
        mesh=None,
        output: str = "uint8",
        clip_skip: int = 0,
        prompt_weighting: bool = False,
        token_weights: Optional[np.ndarray] = None,
        control_images=None,
        controlnet_scale: float = 1.0,
        image_guidance_scale: float = 1.5,
        guidance_rescale: float = 0.0,
        pag_scale: float = 0.0,
        freeu=None,
        encoder_cache_interval: int = 1,
    ):
        """B prompts -> (B, H, W, 3) in one CFG-batched (2B; 3B for
        InstructPix2Pix) request.  ``negative_prompt``: one string for the
        batch or one per prompt (each row gets its own uncond row; cond and
        uncond rows tokenize together to one window count).  ``seeds`` (one
        per prompt) switches to per-request keys: each row's image depends
        only on its own seed, not on its batch (the serving engine relies on
        it); without them ``seed`` keys the whole batch.  ``init_images``
        and ``mask_images`` hold one image per prompt, ``control_images``
        one entry per prompt (a map, or one map per net; the scales are the
        batch's), the other features as in :meth:`generate`.
        ``prompt_weighting`` parses the emphasis of every prompt and
        negative prompt; ``token_weights`` are (B, L) floats aligned with
        ``token_ids`` (the uncond rows weigh 1).  ``output`` as in
        :meth:`generate`, but ``"latents"`` returns the decoded float
        images, as the JAX package's ``generate_batch`` does.

        ``mesh`` (``parallel.make_mesh``/``global_mesh``; every rank of it
        makes the same call): B must divide by dp, and this rank serves the
        dp block of requests ``r * B/dp ... (r + 1) * B/dp - 1`` with all of
        their rows (cond, uncond, images, masks, control maps, weights,
        keys; a scalar ``seed`` draws the whole batch's noise and keeps the
        block's), so that a row equals its unsharded row.  A plain tree
        runs replicated (every tp rank of a dp block computes the same
        rows); a tree from ``shard_params_tp(params, mesh)`` runs
        Megatron-style under ``tp_context(mesh)``.  The images are
        gathered over dp: every rank returns the whole batch."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a sdtpu_torch.parallel mesh (make_mesh, "
                            f"global_mesh), not {type(mesh).__name__}")
        if output not in OUTPUTS:
            raise ValueError(f"unknown output {output!r}")
        cfg = self.config.default_cfg if cfg is None else cfg
        cfg_scale = self.config.default_cfg_scale if cfg_scale is None else cfg_scale
        steps = self.config.default_steps if num_inference_steps is None else num_inference_steps
        sampler = sampler or self.config.default_sampler
        if steps < 1:
            raise ValueError("num_inference_steps must be >= 1")
        size = self._size(image_size)
        max_len = self.config.text_config.max_length
        prompts = list(prompts)
        negs = None
        if cfg:
            negs = (list(negative_prompt) if isinstance(negative_prompt, (list, tuple))
                    else [negative_prompt] * len(prompts))
        uncond = cond_w = uncond_w = None
        n_prompts = len(prompts)
        with stage("tokenize"):
            if prompt_weighting:
                if token_ids is not None:
                    raise ValueError("prompt_weighting parses the prompt strings — with "
                                     "token_ids pass token_weights instead")
                if self.tokenizer is None:
                    raise ValueError("prompt_weighting needs a tokenizer — provide assets "
                                     "via tools/prepare_tokenizer.py")
                ids_all, w_all = self._encode_rows(prompts + (negs or []), max_len,
                                                   weighted=True)
                cond, cond_w = ids_all[:n_prompts], w_all[:n_prompts]
                if negs is not None:
                    uncond, uncond_w = ids_all[n_prompts:], w_all[n_prompts:]
            elif token_ids is not None:
                cond = np.asarray(token_ids)
                if token_weights is not None:
                    cond_w = np.asarray(token_weights, np.float32)
                    if cond_w.ndim == 1:
                        cond_w = cond_w[None]
                    if cond_w.shape != cond.shape:
                        raise ValueError(f"token_weights {cond_w.shape} must match "
                                         f"token_ids {cond.shape}")
            else:
                if token_weights is not None:
                    raise ValueError("token_weights requires token_ids")
                if self.tokenizer is None:
                    raise ValueError("no tokenizer installed: pass token_ids")
                ids_all = self._encode_rows(prompts + (negs or []), max_len)
                cond = ids_all[:n_prompts]
                if negs is not None:
                    uncond = ids_all[n_prompts:]
            weights = cond_w
            if cfg:
                if len(negs) != cond.shape[0]:
                    raise ValueError("negative_prompt list must match the number of prompts")
                if uncond is None:  # pre-tokenized cond: match its window count
                    n_win = cond.shape[1] // max_len
                    if self.tokenizer is not None:
                        uncond = np.asarray([
                            self.tokenizer.encode_long(t, window=max_len, num_windows=n_win)
                            for t in negs])
                    else:
                        if any(n for n in negs):
                            raise ValueError(
                                "no tokenizer installed — non-empty negative prompts "
                                "require a tokenizer (or pre-tokenize 2B token_ids)")
                        uncond = np.tile(np.tile(self._uncond_row(), n_win)[None],
                                         (cond.shape[0], 1))
                ids = np.concatenate([cond, uncond])  # [cond..., uncond...]
                if cond_w is not None:
                    if uncond_w is None:
                        uncond_w = np.ones(uncond.shape, np.float32)
                    weights = np.concatenate([cond_w, uncond_w])
            else:
                ids = cond
            ids = np.asarray(ids, dtype=np.int32)
        is_img2img = init_images is not None
        if is_img2img and not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        if mask_images is not None and not is_img2img:
            raise ValueError("mask_images requires init_images (inpainting)")
        is_edit = is_img2img and self._is_edit()
        if is_edit and mask_images is not None:
            raise ValueError("editing checkpoints (InstructPix2Pix) take no mask")
        has_control = control_images is not None
        with stage("prepare"):
            features = check_features(
                encoder_cache_interval, has_control, guidance_rescale, pag_scale, freeu, cfg,
                is_edit,
                control_rows=(len(control_images), cond.shape[0]) if has_control else None,
                controlnet_loaded=self.controlnet is not None)
            if seeds is not None:
                if len(seeds) != cond.shape[0]:
                    raise ValueError("seeds must match the number of prompts")
                key = np.stack([prng.key(s) for s in seeds])  # per-request keys
            else:
                key = prng.key(seed)
            images = masks = None
            if is_img2img:
                images = np.concatenate([self._prep_image(im, size) for im in init_images])
                if mask_images is not None:
                    if len(mask_images) != len(init_images):
                        raise ValueError("mask_images must match init_images in length")
                    masks = np.concatenate([self._prep_mask(m, size) for m in mask_images])
            control = (self._control_rows(control_images, controlnet_scale, size)
                       if has_control else None)
        run = dict(size=size, steps=steps, cfg=cfg, cfg_scale=cfg_scale, sampler=sampler,
                   strength=strength, image_guidance_scale=image_guidance_scale,
                   clip_skip=clip_skip, **features)
        if mesh is None:
            return self._request(ids, key, images=images, masks=masks, token_weights=weights,
                                 output="float" if output == "latents" else output,
                                 control=control, **run)
        self._check_mesh(mesh)
        n = cond.shape[0]
        rows = mesh.dp_rows(n)

        def block(a):  # this rank's requests in each n-row block of a
            return None if a is None else np.concatenate(
                [a[i:i + n][rows] for i in range(0, a.shape[0], n)])

        if key.ndim == 2:
            key = key[rows]
        with tp_context(mesh):
            out = self._request(block(ids), key, images=block(images), masks=block(masks),
                                token_weights=block(weights),
                                output="device" if output in ("uint8", "device") else "float",
                                control=(None if control is None else
                                         [(net, block(maps), s) for net, maps, s in control]),
                                batch_rows=None if key.ndim == 2 else (rows, n), **run)
        out = mesh.dp_gather(torch.as_tensor(out, device=self.device))
        return out if output == "device" else out.cpu().numpy()

    def warmup(self, *, image_sizes=(512,), step_counts=(25,), batch_sizes=(1,),
               cfg: bool = True, sampler: str = "ddpm", img2img: bool = False,
               inpaint: bool = False, strength: float = 0.9, pag_scale: float = 0.0,
               control_image=None, controlnet_scale=1.0, guidance_rescale: float = 0.0,
               freeu=None, encoder_cache_interval: int = 1) -> int:
        """Run one request of each program a serving deployment will use
        (per-request seeds, as the engine sends them), so that none of its
        requests pays a first use: the kernels' build, the draws' CUDA graph
        capture for each (draws, shape), the UNet's CUDA graph capture for
        each step shape, the libraries' first calls.  The
        step features as in :meth:`generate` (``control_image`` for every
        row).  Returns the number of programs run."""
        n = 0
        max_len = self.config.text_config.max_length
        for size in image_sizes:
            for steps in step_counts:
                for batch in batch_sizes:
                    ids = np.ones((batch, max_len), dtype=np.int64)
                    kw = dict(token_ids=ids, cfg=cfg, num_inference_steps=steps,
                              image_size=size, sampler=sampler, seeds=list(range(batch)),
                              pag_scale=pag_scale, guidance_rescale=guidance_rescale,
                              freeu=freeu, encoder_cache_interval=encoder_cache_interval,
                              control_images=(None if control_image is None
                                              else [control_image] * batch),
                              controlnet_scale=controlnet_scale)
                    if img2img or inpaint:
                        kw.update(
                            init_images=[np.zeros((size, size, 3), dtype=np.uint8)] * batch,
                            mask_images=([np.full((size, size), 255, dtype=np.uint8)] * batch
                                         if inpaint else None),
                            strength=strength)
                    self.generate_batch(["warmup"] * batch, **kw)
                    n += 1
        return n

    @torch.inference_mode()
    def txt2img(self, ids, latents: torch.Tensor, noise: Optional[torch.Tensor], *, cfg: bool,
                cfg_scale: float, output: str = "uint8", clip_skip: int = 0,
                sampler: str = "ddpm", steps: Optional[int] = None, schedule=None,
                continuation: bool = False, image_size: Optional[int] = None,
                token_weights=None, **features):
        """The whole request with its noise given: ``ids`` (rows, L) token
        ids (``[cond..., uncond...]`` under CFG), ``latents`` (B, h, w, 4)
        float32 N(0, 1) initial noise (scaled here by the schedule's
        ``init_sigma``), ``noise`` (steps, B, h, w, 4) float32 variance
        noise, one slice per step, for a stochastic sampler (None for a
        deterministic one).  ``steps`` defaults to ``noise``'s length;
        ``schedule`` to ``sampler``'s for ``steps``.  ``generate`` draws
        both as the JAX package does; a caller may pass any.
        ``continuation``: ``latents`` are a base model's carry already at
        the (sliced) schedule's first step, taken as they are.
        ``image_size`` (SDXL's time ids) defaults to the latents' size.
        ``token_weights``: (rows, L) float32 weights of ``ids``
        (:func:`apply_token_weights`), or None.  ``features``:
        :meth:`denoise`'s ``control``, ``guidance_rescale``, ``pag_scale``,
        ``freeu`` and ``encoder_cache_interval``."""
        sdef = get_sampler(sampler)
        if schedule is None:
            if steps is None:
                if noise is None:
                    raise ValueError("txt2img: pass steps= or the per-step noise")
                steps = noise.shape[0]
            schedule = sdef.make_schedule(self.config.scheduler, steps, device=self.device)
        self._check_noise(sdef, sampler, noise, schedule)
        size = image_size or latents.shape[1] * self.config.vae.downscale_factor
        context, added = self._encode(ids, clip_skip, size=size, cfg=cfg,
                                      token_weights=token_weights)
        lat = latents.float()
        if hasattr(schedule, "init_sigma") and not continuation:
            lat = lat * schedule.init_sigma  # sigma-space samplers start at sigma_max
        lat = self.denoise(context, lat, noise, schedule, cfg=cfg, cfg_scale=cfg_scale,
                           sampler=sampler, added_cond=added, **features)
        return self._finish(lat, output)

    @torch.inference_mode()
    def img2img(self, ids, images: torch.Tensor, enc_noise: torch.Tensor,
                fwd_noise: torch.Tensor, noise: Optional[torch.Tensor], *, cfg: bool,
                cfg_scale: float, schedule, strength: float, sampler: str = "ddpm", masks=None,
                masked_noise: Optional[torch.Tensor] = None,
                image_guidance_scale: float = 1.5, output: str = "uint8", clip_skip: int = 0,
                token_weights=None, **features):
        """The image-conditioned request with its draws given (the JAX
        program's img2img branch, ``sdtpu/pipeline/pipeline.py:1911-2017``):
        ``images`` (B, H, W, 3) float32 in [-1, 1] at the request's size,
        ``enc_noise`` / ``fwd_noise`` (B, h, w, 4) the encoder's posterior
        noise and the forward noise, ``noise`` the per-step noise of a
        stochastic sampler, ``schedule`` made with the request's
        ``strength`` (1 for an editing UNet; a 9-channel inpaint UNet at 1
        starts from pure noise).  ``masks``: (B, h, w, 1) on the latent
        grid for the latent blend, (B, H, W, 1) on the pixel grid for a
        9-channel inpaint UNet, which also takes ``masked_noise``.
        ``token_weights`` and ``features`` as in :meth:`txt2img`."""
        sdef = get_sampler(sampler)
        self._check_noise(sdef, sampler, noise, schedule)
        cdt = self.config.compute_dtype
        vae = dict(attention_impl=self.attention_impl, conv_impl=self.conv_impl)
        init_sigma = getattr(schedule, "init_sigma", 1.0)
        context, added = self._encode(ids, clip_skip, size=images.shape[1], cfg=cfg,
                                      token_weights=token_weights)
        images = images.float()
        extra = inpaint = None
        guidance = None
        with stage("vae_encode"):
            enc = self.params["vae_encoder"]
            if self._is_edit():
                # the image rides extra channels as its posterior mode,
                # unscaled; rows [image, image, zeros] across the branches;
                # the latents start as pure noise
                img_lat = vae_encode(images.to(cdt), None, enc, self.config.vae,
                                     apply_scaling=False, **vae).float()
                extra = torch.cat([img_lat, img_lat, torch.zeros_like(img_lat)]) if cfg \
                    else img_lat
                guidance = image_guidance_scale if cfg else None
                lat = fwd_noise.float() * init_sigma
            else:
                lat0 = vae_encode(images.to(cdt), enc_noise, enc, self.config.vae,
                                  **vae).float()
                if masks is not None and self._is_inpaint_unet():
                    # the UNet takes [latents, mask, masked-image latents]
                    mask_pix = masks.float()
                    masked = images * (mask_pix < 0.5).to(images.dtype)
                    masked_lat = vae_encode(masked.to(cdt), masked_noise, enc,
                                            self.config.vae, **vae).float()
                    f = self.config.vae.downscale_factor
                    mask_lat = mask_pix[:, ::f, ::f, :].expand(*masked_lat.shape[:3], 1)
                    extra = torch.cat([mask_lat, masked_lat], dim=-1)
                    # every guidance branch, PAG's too, takes the same extras
                    reps = (2 if cfg else 1) + (1 if features.get("pag_scale", 0.0) > 0 else 0)
                    if reps > 1:
                        extra = torch.cat([extra] * reps)
                    if round(strength, 6) >= 1.0:  # diffusers' is_strength_max
                        lat = fwd_noise.float() * init_sigma
                    else:
                        lat = sdef.add_noise(schedule, lat0, fwd_noise.float(), 0)
                else:
                    lat = sdef.add_noise(schedule, lat0, fwd_noise.float(), 0)
                    if masks is not None:
                        inpaint = (masks.float(), lat0, fwd_noise.float())
        lat = self.denoise(context, lat, noise, schedule, cfg=cfg, cfg_scale=cfg_scale,
                           sampler=sampler, extra=extra, inpaint=inpaint,
                           image_guidance_scale=guidance, added_cond=added, **features)
        return self._finish(lat, output)

    def denoise(self, context, latents, noise, schedule, *, cfg: bool, cfg_scale: float,
                sampler: str = "ddpm", extra=None, inpaint=None,
                image_guidance_scale: Optional[float] = None,
                added_cond: Optional[dict] = None, control=None, guidance_rescale: float = 0.0,
                pag_scale: float = 0.0, freeu=None, encoder_cache_interval: int = 1):
        """The sampler's loop; ``context`` is (2B, L, D) under CFG, else
        (B, L, D); ``noise`` (steps, B, h, w, 4) for a stochastic sampler,
        else None.  ``extra``: channels concatenated to the UNet's input
        after ``scale_model_input``, already at the model batch.
        ``inpaint``: (mask, clean latents, forward noise) of the latent
        blend.  ``image_guidance_scale``: InstructPix2Pix's third branch
        under CFG (rows [text+image, image, uncond]; the context's uncond
        rows serve the image-only branch too).  ``added_cond``: SDXL's
        add-embedding inputs at the context's rows.  An LCM UNet takes
        ``cfg_scale`` as its guidance embedding.

        ``control``: [(ControlNet tree, (B, H, W, 3) control map in [0, 1],
        scale)], the residuals summed; the nets read the 4-channel latents
        (before ``extra``).  ``pag_scale`` > 0 adds PAG's rows ``[cond,
        (uncond,) perturbed]`` (the cond context again).
        ``guidance_rescale`` rescales the CFG combine against the cond
        rows.  ``freeu``: (b1, b2, s1, s2).  ``encoder_cache_interval`` k:
        in each group of k steps the first runs the encoder, every one the
        decoder on the group's encoder output with its own time
        projections; the ``steps % k`` remainder runs in full."""
        ucfg = self.config.unet
        unet = self.params["unet"]
        cdt = self.config.compute_dtype
        batch = latents.shape[0]
        pag = pag_scale > 0.0
        if image_guidance_scale is not None:
            context = torch.cat([context[:batch], context[batch:], context[batch:]])
        elif pag:
            # the perturbed branch rides the tail rows with the cond text
            context = torch.cat([context, context[:batch]])
            if added_cond is not None:
                added_cond = {k: torch.cat([v, v[:batch]]) for k, v in added_cond.items()}
        n_rep = (3 if image_guidance_scale is not None or (pag and cfg)
                 else 2 if cfg or pag else 1)
        pag_tail = batch if pag else 0
        k_cache = encoder_cache_interval
        if k_cache > 1 and control is not None:
            raise ValueError("encoder_cache_interval is incompatible with ControlNet")
        with stage("precompute"):
            cross_kv = precompute_cross_kv(context, unet, ucfg)
            timestep_cond = None
            if ucfg.time_cond_proj_dim is not None:
                # the guidance scale as an embedding, w = cfg_scale - 1
                # (diffusers' convention), in float32 as the JAX program
                w = (np.float32(cfg_scale) - np.float32(1.0)) * np.float32(1000.0)
                timestep_cond = timestep_embedding(
                    torch.full((n_rep * batch,), float(w), device=latents.device),
                    ucfg.time_cond_proj_dim, flip_sin_to_cos=False, freq_shift=1.0,
                    dtype=cdt)
            time_cache = precompute_time_projections(
                schedule.timesteps, unet, ucfg, batch=n_rep * batch,
                timestep_cond=timestep_cond, added_cond=added_cond, dtype=cdt)
            if extra is not None:
                extra = extra.to(cdt)
            # each ControlNet's cond embedding (every guidance branch's
            # rows), cross K/V and time projections over its own tree
            nets = []
            for net, image, scale in control or ():
                emb = controlnet_cond_embed(to_device(image, latents.device).to(cdt),
                                            net["cond_embedding"])
                nets.append((net, torch.cat([emb] * n_rep) if n_rep > 1 else emb,
                             precompute_cross_kv(context, net, ucfg),
                             precompute_time_projections(
                                 schedule.timesteps, net, ucfg, batch=n_rep * batch,
                                 timestep_cond=timestep_cond, added_cond=added_cond,
                                 dtype=cdt), scale))
        sdef = get_sampler(sampler)
        state = sdef.state_init(latents) if sdef.multistep else None
        lat = latents
        n_steps = schedule.num_steps
        n_grouped = n_steps // k_cache * k_cache if k_cache > 1 else 0
        run = dict(attention_impl=self.attention_impl, conv_impl=self.conv_impl,
                   cross_kv=cross_kv)
        cached = None
        graphs = self._unet_graphs
        key = graph_key(
            (n_rep * batch, *latents.shape[1:3],
             latents.shape[3] + (0 if extra is None else extra.shape[-1])),
            cdt, latents.device, context, cross_kv, time_cache, pag_tail=pag_tail,
            freeu=freeu, added_cond=added_cond is not None,
            timestep_cond=timestep_cond is not None, attention_impl=self.attention_impl,
            conv_impl=self.conv_impl)
        request = graphs.request()

        def forward(lat_in, tc, ctx, kv, control=None):
            # the timesteps are folded into the time projections ``tc``
            return unet_forward(lat_in, None, ctx, unet, ucfg, time_cache=tc, control=control,
                                freeu=freeu, pag_tail=pag_tail,
                                attention_impl=self.attention_impl,
                                conv_impl=self.conv_impl, cross_kv=kv)

        for i in range(n_steps):
            # a plain step on the graph route replays its shape's graph, or
            # runs eagerly and captures it; every other step runs eagerly
            mode = "eager"
            if graph_route(latents.device, attention_impl=self.attention_impl, unet=unet,
                           control=nets, grouped=i < n_grouped):
                mode = "replay" if key in graphs else "capture"
            with stage("unet_step", graph=mode):
                lat_in = torch.cat([lat] * n_rep) if n_rep > 1 else lat
                if sdef.scale_model_input is not None:
                    lat_in = sdef.scale_model_input(schedule, i, lat_in)
                lat_in = lat_in.to(cdt)
                t = schedule.timesteps[i]
                ctrl = None
                for net, emb, kv, tc, scale in nets:
                    r = controlnet_forward(
                        lat_in, t, context, emb, net, ucfg, conditioning_scale=scale,
                        attention_impl=self.attention_impl, conv_impl=self.conv_impl,
                        cross_kv=kv, time_cache=time_cache_step(tc, i))
                    ctrl = r if ctrl is None else {
                        "down": [a + b for a, b in zip(ctrl["down"], r["down"])],
                        "mid": None if r["mid"] is None else ctrl["mid"] + r["mid"]}
                if extra is not None:
                    lat_in = torch.cat([lat_in, extra], dim=-1)
                tc_i = time_cache_step(time_cache, i)
                eps = None
                if mode == "replay":
                    # None where the tree changed since the request started:
                    # its steps then run eagerly on the tree it began with
                    eps = graphs.replay(key, (lat_in, tc_i), (context, cross_kv), request)
                if eps is None:
                    graphs.count_eager()
                    if i >= n_grouped:
                        eps = forward(lat_in, tc_i, context, cross_kv, ctrl)
                        if mode == "capture":
                            graphs.capture(key, forward, (lat_in, tc_i), (context, cross_kv),
                                           request)
                    else:
                        # the encoder at a group's first step; its (x,
                        # skips) serve the group's later steps
                        if i % k_cache == 0:
                            cached = unet_encode(lat_in, tc_i["temb"], context, unet, ucfg,
                                                 time_proj=tc_i, pag_tail=pag_tail, **run)
                        eps = unet_decode(*cached, tc_i["temb"], context, unet, ucfg,
                                          time_proj=tc_i, freeu=freeu, **run)
                eps = eps.float()
                if image_guidance_scale is not None:
                    e_t, e_i, e_u = eps[:batch], eps[batch:2 * batch], eps[2 * batch:]
                    eps = e_u + cfg_scale * (e_t - e_i) + image_guidance_scale * (e_i - e_u)
                elif cfg and pag:
                    cond, uncond, pert = eps[:batch], eps[batch:2 * batch], eps[2 * batch:]
                    eps = uncond + cfg_scale * (cond - uncond) + pag_scale * (cond - pert)
                    if guidance_rescale > 0.0:
                        eps = rescale_noise_cfg(eps, cond, guidance_rescale)
                elif cfg:
                    cond, uncond = eps[:batch], eps[batch:]
                    eps = uncond + cfg_scale * (cond - uncond)
                    if guidance_rescale > 0.0:
                        eps = rescale_noise_cfg(eps, cond, guidance_rescale)
                elif pag:
                    cond, pert = eps[:batch], eps[batch:]
                    eps = cond + pag_scale * (cond - pert)
                z = noise[i] if sdef.stochastic else None
                if sdef.multistep:
                    lat, state = sdef.step(schedule, i, lat, eps, z, state)
                else:
                    lat = sdef.step(schedule, i, lat, eps, z)
                if inpaint is not None:
                    # the preserved region takes the init latents noised to
                    # the step the carry is now at; after the last step, the
                    # clean latents
                    mask_l, ref0, ref_noise = inpaint
                    ref = (ref0 if i == n_steps - 1 else
                           sdef.add_noise(schedule, ref0, ref_noise, min(i + 1, n_steps - 1)))
                    lat = mask_l * lat + (1.0 - mask_l) * ref
        return lat

    # -- internals ------------------------------------------------------------

    @torch.inference_mode()
    def _request(self, ids, key, *, size, steps, cfg, cfg_scale, sampler, strength,
                 image_guidance_scale, images=None, masks=None, latents=None,
                 output="uint8", clip_skip=0, token_weights=None, denoising_end=None,
                 denoising_start=None, batch_rows=None, **features):
        """Draw a request's noise from ``key`` (scalar or per-request) as the
        JAX program does, then run :meth:`txt2img` or :meth:`img2img` with
        ``features`` (:meth:`denoise`'s).  The schedule is cut at
        ``denoising_start``, then at ``denoising_end``.  ``batch_rows``
        (rows, n): the request is that block of a batch of n under one
        scalar key, whose noise is drawn whole and cut to the block."""
        if output not in OUTPUTS:
            raise ValueError(f"unknown output {output!r}")
        sdef = get_sampler(sampler)
        is_img2img = images is not None
        # editing checkpoints denoise from pure noise: strength never truncates
        strength_key = 1.0 if (self._is_edit() or not is_img2img) else round(strength, 6)
        n_train = self.config.scheduler.num_train_timesteps
        with stage("upload"):
            schedule = sdef.make_schedule(self.config.scheduler, steps, strength_key,
                                          device=self.device)
            if denoising_start is not None:
                schedule = slice_schedule(schedule, num_train_timesteps=n_train,
                                          denoising_start=denoising_start)
            if denoising_end is not None:
                schedule = slice_schedule(schedule, num_train_timesteps=n_train,
                                          denoising_end=denoising_end)
        n_noise = schedule.num_steps if sdef.stochastic else 0
        f = self.config.vae.downscale_factor
        lat_shape = (size // f, size // f, self.config.vae.latent_channels)
        if latents is not None:
            program, shape = "latents", tuple(latents.shape)
        elif is_img2img:
            program = ("inpaint" if masks is not None and self._is_inpaint_unet()
                       else "img2img")
            shape = (images.shape[0], *lat_shape)
        else:
            program = "txt2img"
            shape = (ids.shape[0] // 2 if cfg else ids.shape[0], *lat_shape)
        if batch_rows is not None:
            shape = (batch_rows[1], *shape[1:])
        with stage("noise"):
            draws = request_noise(key, n_noise, shape, self.device, program=program,
                                  graphs=self._draws)
        if batch_rows is not None:
            draws = draws[:, batch_rows[0]]
        n_head = len(PROGRAMS[program])
        heads = draws[:n_head]
        noise = draws[n_head:] if sdef.stochastic else None
        run = dict(cfg=cfg, cfg_scale=cfg_scale, sampler=sampler, schedule=schedule,
                   output=output, clip_skip=clip_skip, token_weights=token_weights,
                   **features)
        if latents is not None or is_img2img:
            with stage("upload"):
                if latents is not None:
                    latents = to_device(latents, self.device)
                if is_img2img:
                    images = to_device(images, self.device)
                    masks = None if masks is None else to_device(masks, self.device)
        if not is_img2img:
            lat0 = heads[0] if latents is None else latents
            return self.txt2img(ids, lat0, noise, continuation=denoising_start is not None,
                                image_size=size, **run)
        return self.img2img(ids, images, heads[0], heads[1], noise, strength=strength_key,
                            masks=masks,
                            masked_noise=heads[2] if program == "inpaint" else None,
                            image_guidance_scale=image_guidance_scale, **run)

    def _check_mesh(self, mesh: Mesh) -> None:
        """A tree sharded for another mesh does not run on this one."""
        trees = [("parameters", self.params)]
        if self.controlnet is not None:
            trees += [("ControlNet", net) for net in self._controlnets()]
        for name, tree in trees:
            own = sharded_mesh(tree)
            if own is not None and own != mesh:
                raise ValueError(f"the {name} were sharded for {own}, not for the "
                                 f"request's {mesh}")

    def _refuse_sharded(self, what: str) -> None:
        """Fusing into the leaves needs whole leaves, not tp slices."""
        own = sharded_mesh(self.params)
        if own is not None:
            raise ValueError(f"{what} fuses into whole leaves: call it before "
                             f"shard_params_tp (these parameters are sharded for {own})")

    def _encode(self, ids, clip_skip: int, *, size: int, cfg: bool, token_weights=None):
        """Token rows -> ``(context, added_cond)``.  SD 1.x: one encoder's
        hidden states and no ``added_cond``.  SDXL: CLIP-L's and bigG's
        penultimate states concatenated (768 + 1280), or bigG's alone for a
        bigG-only refiner, with ``added_cond`` = bigG's projected pooled
        output and the time ids ``[size, size, 0, 0, size, size]`` (original
        size, crop, target size); under ``requires_aesthetics_score`` ``[size,
        size, 0, 0, score]``, the score the preset's on the cond rows and its
        negative one on the uncond rows (rows ``[cond..., uncond...]``).
        Both encoders take the same ids, as in the JAX package.
        ``token_weights`` (rows, L) scale each encoder's states apart
        (:func:`apply_token_weights`)."""
        config = self.config
        cdt = config.compute_dtype
        with stage("clip"):
            ids = to_device(np.asarray(ids, np.int64), self.device)
            tw = (None if token_weights is None
                  else to_device(np.asarray(token_weights, np.float32), self.device))
            parts = []
            if config.clip is not None:
                hidden, _ = clip_encode_windows(ids, self.params["clip"], config.clip,
                                                clip_skip=clip_skip)
                if tw is not None:
                    hidden = apply_token_weights(hidden, tw)
                parts.append(hidden.to(cdt))
            if config.clip_2 is None:
                return parts[0], None
            hidden2, pooled2 = clip_encode_windows(ids, self.params["clip_2"], config.clip_2,
                                                   clip_skip=clip_skip)
            if tw is not None:
                hidden2 = apply_token_weights(hidden2, tw)
            parts.append(hidden2.to(cdt))
            context = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
            rows = ids.shape[0]
            if config.requires_aesthetics_score:
                half = rows // 2 if cfg else rows
                score = [config.default_aesthetic_score] * half + [
                    config.default_negative_aesthetic_score] * (rows - half)
                time_ids = [[size, size, 0, 0, a] for a in score]
            else:
                time_ids = [[size, size, 0, 0, size, size]] * rows
            added = {"text_embeds": pooled2.to(cdt),
                     "time_ids": to_device(np.asarray(time_ids, np.float32), self.device)}
            return context, added

    def _finish(self, lat: torch.Tensor, output: str):
        if output == "latents":
            return lat.float().cpu().numpy()
        with stage("vae_decode"):
            img = vae_decode(lat.to(self.config.compute_dtype), self.params["vae_decoder"],
                             self.config.vae, attention_impl=self.attention_impl,
                             conv_impl=self.conv_impl).float()
        if output == "float":
            return img.cpu().numpy()
        with stage("to_uint8"):
            img = to_uint8(img)
        return img if output == "device" else img.cpu().numpy()

    @staticmethod
    def _check_noise(sdef, sampler, noise, schedule) -> None:
        if sdef.stochastic and (noise is None or noise.shape[0] != schedule.num_steps):
            raise ValueError(f"sampler {sampler!r} takes one noise slice per step "
                             f"({schedule.num_steps})")

    def _is_edit(self) -> bool:
        """An InstructPix2Pix-style editing UNet: latents ++ image latents."""
        return self.config.unet.in_channels == 2 * self.config.vae.latent_channels

    def _is_inpaint_unet(self) -> bool:
        """A dedicated inpainting UNet: latents ++ mask ++ masked-image latents."""
        return self.config.unet.in_channels == 2 * self.config.vae.latent_channels + 1

    def _size(self, image_size) -> int:
        size = image_size or self.config.default_image_size
        f = self.config.vae.downscale_factor
        if size <= 0 or size % f:
            raise ValueError(f"image_size must be a positive multiple of {f}")
        return size

    def _uncond_row(self) -> np.ndarray:
        """BOS then EOS padding: the empty prompt's row for CFG's
        unconditional branch when only the cond row was given."""
        vocab = self.config.text_config.vocab_size
        row = np.full((self.config.text_config.max_length,), vocab - 1, dtype=np.int64)
        row[0] = vocab - 2
        return row

    def _encode_rows(self, texts, max_len: int, *, weighted: bool = False):
        """Tokenize texts to one window count (the most any row needs):
        (B, n * max_len) int32, and with ``weighted`` the (B, n * max_len)
        float32 weights of their emphasis syntax beside them."""
        tok = self.tokenizer
        if weighted:
            enc = [tok.encode_weighted_long(t, window=max_len) for t in texts]
            n = max(len(e[0]) // max_len for e in enc)
            enc = [e if len(e[0]) == n * max_len
                   else tok.encode_weighted_long(t, window=max_len, num_windows=n)
                   for e, t in zip(enc, texts)]
            return (np.asarray([e[0] for e in enc], np.int32),
                    np.asarray([e[1] for e in enc], np.float32))
        enc = [tok.encode_long(t, window=max_len) for t in texts]
        n = max(len(e) // max_len for e in enc)
        enc = [e if len(e) == n * max_len else tok.encode_long(t, window=max_len, num_windows=n)
               for e, t in zip(enc, texts)]
        return np.asarray(enc, np.int32)

    def _tokenize(self, prompt, negative_prompt, cfg, token_ids, weighted: bool = False):
        """The request's token rows ``[cond(, uncond)]`` (int32); with
        ``weighted`` the (ids, weights) of both prompts' emphasis syntax."""
        max_len = self.config.text_config.max_length
        if weighted:
            if token_ids is not None:
                raise ValueError("prompt_weighting parses the prompt string — with "
                                 "token_ids pass token_weights instead")
            if self.tokenizer is None:
                raise ValueError("prompt_weighting needs a tokenizer — provide assets via "
                                 "tools/prepare_tokenizer.py (or pass token_ids + "
                                 "token_weights)")
            return self._encode_rows([prompt] + ([negative_prompt] if cfg else []), max_len,
                                     weighted=True)
        if token_ids is not None:
            ids = np.asarray(token_ids)
            if ids.ndim == 1:
                ids = ids[None]
        else:
            if self.tokenizer is None:
                raise ValueError("no tokenizer installed: pass token_ids")
            ids = self._encode_rows([prompt] + ([negative_prompt] if cfg else []), max_len)
        if cfg and ids.shape[0] == 1:
            n = ids.shape[1] // max_len
            if self.tokenizer is not None:
                neg = self.tokenizer.encode_long(negative_prompt, window=max_len,
                                                 num_windows=n)
                ids = np.concatenate([ids, np.asarray(neg)[None]], axis=0)
            else:
                ids = np.concatenate([ids, np.tile(self._uncond_row(), n)[None]], axis=0)
        return np.asarray(ids, dtype=np.int32)

    @staticmethod
    def _prep_image(init_image, size) -> np.ndarray:
        """Init image -> (1, size, size, 3) float32 in [-1, 1] on the host:
        uint8 rescaled, then a nearest resize to the request's size."""
        arr = np.asarray(init_image)
        if arr.dtype == np.uint8:
            arr = from_uint8(arr)
        if arr.ndim == 3:
            arr = arr[None]
        img = np.asarray(arr, dtype=np.float32)
        if img.shape[1] != size or img.shape[2] != size:
            img = resize_image(torch.from_numpy(img), size, size).numpy()
        return img

    @staticmethod
    def _nearest_resize(arr: np.ndarray, size: int) -> np.ndarray:
        """Nearest-neighbour resize to (size, size) over the two leading
        axes, on the host."""
        if arr.shape[:2] == (size, size):
            return arr
        ri = (np.arange(size) * arr.shape[0] // size).clip(0, arr.shape[0] - 1)
        ci = (np.arange(size) * arr.shape[1] // size).clip(0, arr.shape[1] - 1)
        return arr[ri[:, None], ci[None, :]]

    def _prep_control(self, control_image, size) -> np.ndarray:
        """Control map -> (1, size, size, 3) float32 in [0, 1] on the host:
        (H, W) or (H, W, 1|3), uint8 or float; grey maps broadcast to three
        channels; a nearest resize to the request's size."""
        arr = np.asarray(control_image)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        arr = arr.astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        if arr.shape[-1] != 3:
            raise ValueError(f"control image must be (H, W[, 1|3]); got {arr.shape}")
        arr = self._nearest_resize(arr, size)
        return np.clip(arr, 0.0, 1.0)[None].astype(np.float32)

    def _prep_mask(self, mask_image, size) -> np.ndarray:
        """Inpainting mask -> (1, h, w, 1) float32 in [0, 1] (1 = repaint,
        0 = preserve).  Accepts (H, W), (H, W, 1) or (H, W, 3) uint8 (255 =
        repaint) or floats; nearest-resized to the image grid, then
        area-averaged to the latent grid, except for a 9-channel inpaint
        UNet, which takes the pixel-grid mask."""
        arr = np.asarray(mask_image)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        arr = arr.astype(np.float32)
        if arr.ndim == 3:
            arr = arr.mean(axis=-1)
        if arr.ndim != 2:
            raise ValueError(f"mask must be (H, W[, C]); got {arr.shape}")
        arr = self._nearest_resize(arr, size)
        if self._is_inpaint_unet():
            return np.clip(arr, 0.0, 1.0)[None, :, :, None].astype(np.float32)
        f = self.config.vae.downscale_factor
        lat = size // f
        m = arr.reshape(lat, f, lat, f).mean(axis=(1, 3))
        return np.clip(m, 0.0, 1.0)[None, :, :, None].astype(np.float32)
