"""Command-line demo of the port, the counterpart of the JAX package's
``demo.py``::

    python -m sdtpu_torch.demo [--prompt "a cat flying a spaceship"] [--model-dir DIR]
        [--preset tiny-sd] [--image-size N] [--steps N] [--seed 40] [--sampler NAME]
        [--cfg-scale S | --no-cfg] [--init-image PNG [--mask-image PNG] [--strength S]]
        [--image-guidance-scale S] [--int8] [--out out.png] [--device cuda]
        [--refiner DIR_OR_PRESET [--denoising-split 0.8]]
        [--controlnet PATH --control-image PNG [--controlnet-scale S]]...
        [--pag-scale S] [--freeu B1,B2,S1,S2] [--guidance-rescale R]
        [--encoder-cache K] [--hires-base PX [--hires-strength S]]
        [--lora PATH[:SCALE]]... [--textual-inversion PATH[:TOKEN]]...
        [--prompt-weighting]

Without ``--model-dir`` it runs seeded random weights (the structured
noise is the expected output); ``--model-dir`` loads a local diffusers
checkpoint directory.  ``--refiner`` (a checkpoint directory or a preset
such as ``sdxl-refiner``, random weights) hands the base model's latents
at ``--denoising-split`` of the schedule to the refiner, which finishes
the image (txt2img only).  ``--controlnet`` (a diffusers ControlNet file
or directory; repeated for several nets, each with its ``--control-image``
and optionally its ``--controlnet-scale``), ``--pag-scale``, ``--freeu``,
``--guidance-rescale`` and ``--encoder-cache`` go to ``generate``;
``--hires-base`` runs ``generate_hires`` from that base size (plain
txt2img only).  ``--lora`` fuses an adapter (kohya or diffusers-peft
safetensors) at SCALE (default 1; repeated, adapters stack),
``--textual-inversion`` appends an embedding's vectors under TOKEN (the
file's own key where it has one), each printing what it loaded, before
``--int8``; ``--prompt-weighting`` parses ``(word:1.3)`` / ``[word]``
emphasis and needs a tokenizer.  Without a tokenizer the prompt hashes to
fixed token ids, as in the JAX demo.  Images are read and written as PNG by
``utils/image.py`` (8-bit grey, RGB or RGBA in).  On the card by default;
``--device cpu`` is for the tests.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompt", default="a cat flying a spaceship")
    ap.add_argument("--negative-prompt", default="")
    ap.add_argument("--model-dir", default=None, help="local diffusers-layout checkpoint dir")
    ap.add_argument("--preset", default="tiny-sd")
    ap.add_argument("--image-size", type=int, default=None,
                    help="default: the preset's native size")
    ap.add_argument("--steps", type=int, default=None,
                    help="default: the preset's native step count")
    ap.add_argument("--seed", type=int, default=40)
    ap.add_argument("--sampler", default=None,
                    help="a name of sdtpu_torch.samplers.SAMPLERS (default: the preset's)")
    ap.add_argument("--cfg-scale", type=float, default=None)
    ap.add_argument("--no-cfg", action="store_true")
    ap.add_argument("--init-image", default=None, help="img2img input PNG")
    ap.add_argument("--mask-image", default=None,
                    help="inpainting mask PNG (white = repaint); requires --init-image")
    ap.add_argument("--strength", type=float, default=0.9)
    ap.add_argument("--image-guidance-scale", type=float, default=1.5,
                    help="InstructPix2Pix checkpoints (--preset ip2p): the image branch's scale")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8-quantize the UNet's resnet convs (kernel D)")
    ap.add_argument("--int8-transformer", nargs="?", const=True, default=False,
                    choices=["full"],
                    help="with --int8: also the post-LN transformer matmuls ('full': and "
                         "the out-projections and GeGLU down-projection)")
    ap.add_argument("--int8-vae", action=argparse.BooleanOptionalAction, default=None,
                    help="with --int8: also the VAE decoder's resnet convs")
    ap.add_argument("--clip-skip", type=int, default=0)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--freeu", default=None, metavar="B1,B2,S1,S2",
                    help="FreeU factors, e.g. 1.5,1.6,0.9,0.2 for SD 1.x")
    ap.add_argument("--guidance-rescale", type=float, default=0.0,
                    help="CFG rescale factor in (0, 1]")
    ap.add_argument("--pag-scale", type=float, default=0.0,
                    help="Perturbed-Attention Guidance scale (a third guidance branch)")
    ap.add_argument("--hires-base", type=int, default=None, metavar="PX",
                    help="two-pass hires fix: txt2img at this size, then img2img at the "
                         "target size")
    ap.add_argument("--hires-strength", type=float, default=0.7,
                    help="the hires fix's second-pass strength")
    ap.add_argument("--controlnet", action="append", default=[], metavar="PATH",
                    help="a diffusers ControlNet safetensors file or directory; repeatable")
    ap.add_argument("--control-image", action="append", default=[],
                    help="control map PNG, one per --controlnet")
    ap.add_argument("--controlnet-scale", type=float, action="append", default=[],
                    help="one per --controlnet (default 1)")
    ap.add_argument("--encoder-cache", type=int, default=1, metavar="K",
                    help="run the UNet's encoder once per K steps")
    ap.add_argument("--lora", action="append", default=[], metavar="PATH[:SCALE]",
                    help="fuse a LoRA adapter safetensors (kohya or diffusers-peft layout) "
                         "into the weights; repeatable, adapters stack")
    ap.add_argument("--textual-inversion", action="append", default=[],
                    metavar="PATH[:TOKEN]",
                    help="append a textual-inversion embedding; TOKEN names the placeholder "
                         "of the emb_params and dual-encoder layouts; repeatable")
    ap.add_argument("--prompt-weighting", action="store_true",
                    help="parse (word:1.3) / [word] emphasis in the prompts (needs a "
                         "tokenizer)")
    ap.add_argument("--refiner", default=None, metavar="DIR_OR_PRESET",
                    help="SDXL refiner checkpoint dir or preset (sdxl-refiner): the base "
                         "model runs the high-noise head, the refiner finishes from its "
                         "latents")
    ap.add_argument("--denoising-split", type=float, default=0.8,
                    help="base/refiner handoff fraction")
    args = ap.parse_args(argv)
    if args.refiner and (args.init_image or args.mask_image):
        ap.error("--refiner composes with txt2img only")
    if args.controlnet:
        if len(args.control_image) != len(args.controlnet):
            ap.error("need exactly one --control-image per --controlnet")
        if args.controlnet_scale and len(args.controlnet_scale) != len(args.controlnet):
            ap.error("need one --controlnet-scale per --controlnet (or none)")
    elif args.control_image:
        ap.error("--control-image requires --controlnet")
    if args.hires_base and (args.init_image or args.mask_image or args.refiner):
        ap.error("--hires-base composes with plain txt2img only")
    return args


def hashed_ids(prompt: str, text_config):
    """A stable hash of the prompt to one token row, beside a zero row (the
    JAX demo's ids when there is no tokenizer; str.__hash__ is salted per
    process)."""
    import zlib

    import numpy as np

    rng = np.random.default_rng(zlib.crc32(prompt.encode()))
    row = rng.integers(0, text_config.vocab_size, text_config.max_length)
    return np.stack([row, np.zeros_like(row)])


def main(argv=None) -> None:
    args = parse_args(argv)
    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.utils.image import load_image, save_png

    if args.model_dir:
        pipe = StableDiffusionPipeline.from_pretrained(args.model_dir, preset=args.preset,
                                                       device=args.device)
    else:
        print("no --model-dir: running seeded random weights")
        pipe = StableDiffusionPipeline.from_random(args.preset, device=args.device)
    for spec in args.lora:
        path, _, s = spec.rpartition(":")
        try:
            path, scale = (path, float(s)) if path else (spec, 1.0)
        except ValueError:
            path, scale = spec, 1.0
        report = pipe.load_lora(path, scale=scale)
        print(f"lora {path} (scale {scale}): {report['applied']} modules"
              + (f", skipped {len(report['skipped'])}" if report["skipped"] else ""))
    for spec in args.textual_inversion:
        path, _, tok = spec.rpartition(":")
        path, tok = (path, tok) if path else (spec, None)
        reg = pipe.load_textual_inversion(path, token=tok)
        print(f"textual inversion {path}: "
              + ", ".join(f"{t} -> {ids}" for t, ids in reg.items()))
    if args.int8:
        pipe.quantize_int8(transformer=args.int8_transformer, vae=args.int8_vae)
    cn_scales = args.controlnet_scale or [1.0] * len(args.controlnet)
    if args.controlnet:
        pipe.load_controlnet(args.controlnet[0] if len(args.controlnet) == 1
                             else args.controlnet)
        for path, scale in zip(args.controlnet, cn_scales):
            print(f"controlnet {path} (scale {scale})")
    control = [load_image(p) for p in args.control_image]
    token_ids = None
    if pipe.tokenizer is None:
        if args.prompt_weighting:
            raise SystemExit("demo: error: --prompt-weighting needs a tokenizer (a "
                             "--model-dir with tokenizer/, or the default assets)")
        print("no tokenizer assets: hashing the prompt to fixed token ids")
        token_ids = hashed_ids(args.prompt, pipe.config.text_config)
    refiner = None
    if args.refiner:
        import os

        if os.path.isdir(args.refiner):
            refiner = StableDiffusionPipeline.from_pretrained(args.refiner, device=args.device)
        else:
            print(f"refiner preset {args.refiner}: random weights")
            refiner = StableDiffusionPipeline.from_random(args.refiner, device=args.device)
    t0 = time.perf_counter()
    gen, extra = pipe.generate, {}
    if args.hires_base:
        gen = pipe.generate_hires
        extra = dict(base_size=args.hires_base, hires_strength=args.hires_strength)
    image = gen(
        args.prompt, args.negative_prompt, **extra, strength=args.strength,
        cfg=False if args.no_cfg else None, cfg_scale=args.cfg_scale,
        num_inference_steps=args.steps, seed=args.seed,
        init_image=load_image(args.init_image) if args.init_image else None,
        mask_image=load_image(args.mask_image) if args.mask_image else None,
        image_size=args.image_size,
        token_ids=token_ids,
        sampler=args.sampler, clip_skip=args.clip_skip,
        prompt_weighting=args.prompt_weighting,
        image_guidance_scale=args.image_guidance_scale,
        guidance_rescale=args.guidance_rescale, pag_scale=args.pag_scale,
        freeu=tuple(float(v) for v in args.freeu.split(",")) if args.freeu else None,
        encoder_cache_interval=args.encoder_cache,
        control_image=(control if len(control) > 1 else control[0] if control else None),
        controlnet_scale=cn_scales if len(cn_scales) > 1 else cn_scales[0] if cn_scales else 1.0,
        denoising_end=args.denoising_split if refiner else None,
        output="latents" if refiner else "uint8")
    if refiner:
        image = refiner.generate(
            args.prompt, args.negative_prompt, cfg=False if args.no_cfg else None,
            cfg_scale=args.cfg_scale, num_inference_steps=args.steps, seed=args.seed,
            # the latent grid is the base model's
            image_size=args.image_size or pipe.config.default_image_size,
            token_ids=(hashed_ids(args.prompt, refiner.config.text_config)
                       if refiner.tokenizer is None else None),
            sampler=args.sampler, latents=image, denoising_start=args.denoising_split)
    dt = time.perf_counter() - t0
    save_png(image, args.out)
    print(f"wrote {args.out} ({image.shape[1]}x{image.shape[2]}) in {dt:.2f}s "
          "(the first call includes the kernels' build)")


if __name__ == "__main__":
    main()
