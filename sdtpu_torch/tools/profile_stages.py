"""Stage-level timing of the port: CLIP encode, one CFG-batched UNet step,
VAE decode, and the ideal request total, the counterpart of the JAX
package's ``tools/profile_stages.py``::

    python -m sdtpu_torch.tools.profile_stages [preset] [image_size] [--device cpu]

Each stage runs on zero parameters of the preset's shapes, ``n`` times after
``warmup`` calls, each call ended by a device sync; it prints the best and
the median.  On the card by default (and it exits non-zero without one);
``--device cpu`` is for the tests.
"""

from __future__ import annotations

import argparse
import statistics
import time


def timeit(fn, *args, n: int = 10, warmup: int = 2):
    """(best, median) seconds of ``fn(*args)``, each call synchronised."""
    from sdtpu_torch.utils.runtime import device_sync

    for _ in range(warmup):
        device_sync(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        device_sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return min(times), statistics.median(times)


def main(argv=None) -> dict:
    """Print and return ``{stage: (best_s, median_s)}`` and the ideal total."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("preset", nargs="?", default="tiny-sd")
    ap.add_argument("image_size", nargs="?", type=int, default=512)
    ap.add_argument("--steps", type=int, default=25, help="steps of the ideal total")
    ap.add_argument("--n", type=int, default=10, help="timed calls per stage")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from sdtpu_torch.config import get_preset
    from sdtpu_torch.models.clip import clip_encode
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.models.vae import vae_decode
    from sdtpu_torch.tools import require_cuda
    from sdtpu_torch.utils.weights import zero_pipeline_params

    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda("profile_stages")
    config = get_preset(args.preset)
    lat = args.image_size // config.vae.downscale_factor
    params = zero_pipeline_params(config, device=device)
    cd = config.compute_dtype
    length = config.text_config.max_length
    ids = torch.ones((2, length), dtype=torch.int64, device=device)
    latents = torch.zeros((2, lat, lat, config.unet.in_channels), dtype=cd, device=device)
    ts = torch.full((2,), 500.0, device=device)
    ctx = torch.zeros((2, length, config.unet.cross_attention_dim), dtype=cd, device=device)
    z = torch.zeros((1, lat, lat, config.vae.latent_channels), dtype=cd, device=device)

    def clip_fn():
        return clip_encode(ids, params["clip"], config.clip)[0]

    def unet_fn():
        return unet_forward(latents, ts, ctx, params["unet"], config.unet)

    def vae_fn():
        return vae_decode(z, params["vae_decoder"], config.vae)

    out = {}
    with torch.inference_mode():
        for name, fn in [(f"clip (2x{length})", clip_fn),
                         (f"unet step (2x{lat}x{lat})", unet_fn),
                         (f"vae decode (1x{lat}x{lat})", vae_fn)]:
            best, med = timeit(fn, n=args.n)
            out[name.split(" (")[0]] = (best, med)
            print(f"{name:28s} best {best * 1000:8.2f} ms   median {med * 1000:8.2f} ms")
    total = out["clip"][0] + args.steps * out["unet step"][0] + out["vae decode"][0]
    out["ideal_total"] = total
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    print(f"\nideal {args.steps}-step total = clip + {args.steps}*unet + vae = "
          f"{total * 1000:.1f} ms ({where})")
    return out


if __name__ == "__main__":
    main()
