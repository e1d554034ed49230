"""Cells of the benchmark cut to a size the CPU runs in seconds: the same
runners, traffic kinds and readers, tiny widths and loads."""
import copy

from harness import manifest

# limits for the tiny cells: above what sound tiny runs read on the CPU,
# below what a token altered or the cache left unwritten reads
TINY_LIMITS = {
    "open_loop": {"served_gap": 1e-3, "short_requests": 0},
    "closed_loop": {"served_gap": 1e-3, "short_requests": 0},
}


def tiny_cell(name: str) -> dict:
    c = copy.deepcopy(manifest.cell(manifest.load_manifest(), name))
    cfg, mix = c["cfg"], c["mix"]
    cfg.update(hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position=256)
    cfg.update(vocab_size=512, real_vocab_size=500)
    kind = mix["kind"]
    mix["engine"].update(max_len=160, slots=4, max_queue=256,
                         block_size=8, num_blocks=128,
                         prefill_chunk_tokens=16)
    mix.update(vocab=500, check_requests=3, stretch_s=0.3, preroll_s=0.5)
    # weights large enough that attention decides the tokens
    cfg["init_std"] = 0.3
    if kind == "open_loop":
        mix.update(rate_per_s=4.0, grace_s=20,
                   prompt_len={"lognormal": {"median": 30, "sigma": 0.6},
                               "min": 8, "max": 100},
                   output_len={"lognormal": {"median": 8, "sigma": 0.6},
                               "min": 2, "max": 40})
    else:
        mix.update(clients=8, prefixes=2, prefix_len=32,
                   tail_len={"uniform": [4, 16]},
                   output_len={"uniform": [4, 16]})
    c["limits"] = dict(TINY_LIMITS[kind])
    return c
