"""The multi-rank dry run, the counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``::

    python -m sdtpu_torch.tools.dryrun_multichip [n]      # default 4

Starts ``n`` processes on gloo (a ``file://`` rendezvous in a temporary
directory, ``OMP_NUM_THREADS=1``), one rank each, on the CPU.  Each builds
``make_mesh(dp, tp)`` with tp = 2 when n is even (dp = n / tp) and runs the
JAX dry run's four segments at its tiny config, each against the port's
one-process run of the same call within ``atol=2e-4``:

1. a 2-step txt2img ``generate_batch`` of dp rows (per-request seeds) over
   the mesh on ``shard_params_tp``'s tree;
2. img2img with a mask (the latent blend) at strength 1;
3. a ControlNet (non-zero zero convs) kept replicated over the tp-sharded
   base tree, with one control map per row;
4. ring attention over the n ranks (``ProcessGroupRing``) in a UNet
   forward, against dense attention.

``SDTPU_DRYRUN_SEGMENTS=devices`` stops after the mesh and the world are
built.  A run longer than ``SDTPU_DRYRUN_BUDGET_S`` (240) warns on stderr;
it does not fail.  :func:`run_ranks` is the launcher, also used by the
tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(argv, n: int, *, timeout: float = 600) -> list:
    """Run ``argv + [rank, n, rendezvous URL]`` as n processes at once and
    wait for them; returns their outputs (stdout and stderr), in rank
    order.  Raises RuntimeError with every rank's output when one fails or
    the time runs out; every process is ended before it returns."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        url = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [subprocess.Popen([*map(str, argv), str(r), str(n), url], env=env, cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(n)]
        logs, deadline = [], time.monotonic() + timeout
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            logs.append(f"timed out after {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if len(logs) < n or any(p.returncode for p in procs):
        raise RuntimeError("ranks failed (exit codes "
                           f"{[p.returncode for p in procs]}):\n" + "\n".join(
                               f"--- rank {r} ---\n{log}" for r, log in enumerate(logs)))
    return logs


def dryrun_config():
    """The JAX dry run's tiny pipeline (``__graft_entry__.py:174-196``)."""
    import torch

    from sdtpu_torch.config import (
        CLIPConfig,
        PipelineConfig,
        SchedulerConfig,
        UNetConfig,
        VAEConfig,
    )

    return PipelineConfig(
        name="dryrun/tiny",
        clip=CLIPConfig(vocab_size=256, hidden_size=32, intermediate_size=64,
                        num_layers=2, num_heads=2, max_length=16),
        unet=UNetConfig(block_out_channels=(16, 24, 32), layers_per_block=1,
                        attention_levels=(True, True, True), num_attention_heads=2,
                        cross_attention_dim=32, norm_num_groups=8),
        vae=VAEConfig(block_out_channels=(8, 16, 16), layers_per_block=1, norm_num_groups=8),
        scheduler=SchedulerConfig(),
        default_image_size=32,
        compute_dtype=torch.float32,
        param_dtype=torch.float32,
    )


def _close(label: str, got, want, atol: float = 2e-4) -> None:
    import numpy as np

    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    if not np.isfinite(np.asarray(got)).all() or err > atol:
        raise AssertionError(f"{label} diverged from the one-process run: max |diff| "
                             f"{err:.3g} > {atol}")


def _rank_main(rank: int, world: int, url: str) -> None:
    """One rank of the dry run (see the module's docstring)."""
    import numpy as np
    import torch

    from sdtpu_torch.models.controlnet import init_controlnet
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.parallel import (
        ProcessGroupRing,
        initialize,
        make_mesh,
        ring_context,
        shard_params_tp,
    )
    from sdtpu_torch.pipeline.pipeline import StableDiffusionPipeline

    t0 = time.monotonic()
    torch.set_num_threads(1)
    initialize(url, world, rank, backend="gloo")
    tp = 2 if world % 2 == 0 else 1
    dp = world // tp
    mesh = make_mesh(dp, tp)
    if os.environ.get("SDTPU_DRYRUN_SEGMENTS") == "devices":
        if rank == 0:
            print(f"dryrun_multichip DEVICES-ONLY OK: {torch.distributed.get_world_size()} "
                  f"ranks (gloo, {mesh.device.type}), mesh(dp={dp}, tp={tp})")
        torch.distributed.destroy_process_group()
        return

    config = dryrun_config()
    pipe = StableDiffusionPipeline.from_random(config, seed=0, device="cpu")
    sharded = StableDiffusionPipeline(config, shard_params_tp(pipe.params, mesh), device="cpu")
    batch, steps = dp, 2  # one image per dp row; 2 steps carry the loop's state
    cond = np.tile(np.array([[1, 5, 9, 2] + [0] * 12]), (batch, 1))
    kw = dict(token_ids=cond, seeds=list(range(batch)), num_inference_steps=steps,
              image_size=32, output="float")
    prompts = ["p"] * batch

    # segment 1: txt2img
    want = pipe.generate_batch(prompts, **kw)
    out = sharded.generate_batch(prompts, mesh=mesh, **kw)
    if out.shape != (batch, 32, 32, 3):
        raise AssertionError(f"sharded txt2img gave {out.shape}")
    _close("sharded txt2img", out, want)

    # segment 2: img2img with a mask (the latent blend)
    rng = np.random.default_rng(0)
    init = [a for a in rng.standard_normal((batch, 32, 32, 3)).astype(np.float32).clip(-1, 1)]
    mask = np.zeros((32, 32), np.float32)
    mask[:, 16:] = 1.0  # right half repainted
    img_kw = dict(kw, init_images=init, mask_images=[mask] * batch, strength=1.0)
    _close("sharded inpainting", sharded.generate_batch(prompts, mesh=mesh, **img_kw),
           pipe.generate_batch(prompts, **img_kw))

    # segment 3: a replicated ControlNet over the tp-sharded base tree
    cn = init_controlnet(5, config.unet, cond_channels=(4, 8, 16))
    cn["zero_convs"] = [{"kernel": torch.full_like(zc["kernel"], 0.05), "bias": zc["bias"]}
                        for zc in cn["zero_convs"]]
    pipe.load_controlnet(cn)
    sharded.load_controlnet(cn)
    ctrl = rng.uniform(0.0, 1.0, (batch, 32, 32, 3)).astype(np.float32)
    cn_kw = dict(kw, control_images=list(ctrl), controlnet_scale=0.8)
    want_cn = pipe.generate_batch(prompts, **cn_kw)
    if np.abs(want_cn - want).max() == 0:
        raise AssertionError("the control residuals had no effect")
    _close("sharded ControlNet txt2img", sharded.generate_batch(prompts, mesh=mesh, **cn_kw),
           want_cn)

    # segment 4: ring attention over the world's ranks against dense
    lat = torch.from_numpy(rng.standard_normal((2, 32, 32, 4)).astype(np.float32))
    ts = torch.full((2,), 500.0)
    ctx = torch.from_numpy(rng.standard_normal((2, 7, config.unet.cross_attention_dim))
                           .astype(np.float32))
    with torch.inference_mode():
        dense = unet_forward(lat, ts, ctx, pipe.params["unet"], config.unet,
                             attention_impl="xla")
        with ring_context(ProcessGroupRing()):
            ringed = unet_forward(lat, ts, ctx, pipe.params["unet"], config.unet,
                                  attention_impl="ring")
    _close("ring attention", ringed, dense)

    torch.distributed.destroy_process_group()
    if rank == 0:
        print(f"dryrun_multichip OK: mesh(dp={dp}, tp={tp}) over {world} ranks, {steps}-step "
              f"txt2img+inpaint(blend)+controlnet parity vs one process, ring attention over "
              f"{world} ranks parity vs dense, output {out.shape}, "
              f"{time.monotonic() - t0:.1f}s")


def dryrun_multichip(n: int = 4) -> str:
    """Run the dry run over ``n`` gloo processes; returns rank 0's report
    line (raises when a rank fails)."""
    t0 = time.monotonic()
    logs = run_ranks([sys.executable, "-m", "sdtpu_torch.tools.dryrun_multichip", "--rank"],
                     n, timeout=900)
    elapsed = time.monotonic() - t0
    budget = float(os.environ.get("SDTPU_DRYRUN_BUDGET_S", "240"))
    if elapsed > budget:
        print(f"WARNING: dryrun took {elapsed:.1f}s > soft budget {budget:.0f}s",
              file=sys.stderr)
    return logs[0].strip()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=4, help="ranks (processes)")
    ap.add_argument("--rank", nargs=3, metavar=("RANK", "WORLD", "URL"),
                    help="run one rank (the launcher passes these)")
    args = ap.parse_args(argv)
    if args.rank:
        _rank_main(int(args.rank[0]), int(args.rank[1]), args.rank[2])
    else:
        print(dryrun_multichip(args.n))


if __name__ == "__main__":
    main()
