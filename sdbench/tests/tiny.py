"""A toy configuration and cell for the benchmark's CPU tests: the
configuration file's keys at widths a CPU runs in seconds."""

import copy
import json

from sdbench import spec

TINY = {
    "name": "tiny", "source": "the benchmark's tests", "preset": None, "dtype": "bfloat16",
    "image_size": 16, "steps": 3, "sampler": "ddpm", "cfg_scale": 7.5,
    "clip": {"vocab_size": 1000, "hidden_size": 32, "intermediate_size": 64, "num_layers": 2,
             "num_heads": 2, "max_length": 77, "hidden_act": "quick_gelu",
             "layer_norm_eps": 1e-5, "use_final_layer_norm_output": True,
             "projection_dim": None},
    "clip_2": None,
    "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
             "layers_per_block": 1, "attention_levels": [True, True],
             "transformer_layers_per_block": [1, 1], "num_attention_heads": 2,
             "cross_attention_dim": 32, "mid_block": False, "norm_num_groups": 32,
             "time_embed_dim_mult": 4, "freq_shift": 0.0, "flip_sin_to_cos": True,
             "addition_embed_dim": None, "addition_time_embed_dim": None,
             "time_cond_proj_dim": None},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [32, 64], "layers_per_block": 1, "norm_num_groups": 32,
            "scaling_factor": 0.18215},
    "scheduler": {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
                  "beta_schedule": "scaled_linear", "prediction_type": "epsilon",
                  "steps_offset": 0, "timestep_spacing": "leading",
                  "rescale_betas_zero_snr": False},
}

# an SDXL-shaped toy: two encoders (the second projected, penultimate
# states), the add-embedding, a mid block, a level without attention
TINY_XL = copy.deepcopy(TINY)
TINY_XL.update(name="tiny-xl", clip_2={**TINY["clip"], "hidden_size": 64, "num_heads": 2,
                                       "hidden_act": "gelu", "projection_dim": 32,
                                       "use_final_layer_norm_output": False})
TINY_XL["clip"]["use_final_layer_norm_output"] = False
TINY_XL["unet"].update(attention_levels=[False, True], transformer_layers_per_block=[1, 2],
                       num_attention_heads=0, block_out_channels=[64, 128], mid_block=True,
                       cross_attention_dim=96, addition_embed_dim=32 + 6 * 8,
                       addition_time_embed_dim=8)

# the tiny configuration's own limit: its bf16 program reads 0.7-1.5
# levels against the float32 reference, the fp8 control 6-14
TINY_LIMIT = 3.0


def mix(name: str, **changes) -> dict:
    m = json.loads((spec.HERE / "traffic" / f"{name}.json").read_text())
    m.update(changes)
    return m


def cell(mix_: dict, config: dict = TINY, sample: int = 2,
         limit: float = TINY_LIMIT) -> spec.Cell:
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    return spec.Cell(name="tiny", chips=1, config=config, traffic=mix_,
                     check={"sample": sample, "limits": {"mean_abs_levels": limit}},
                     end_to_end=bench["end_to_end"], per_layer=[])
