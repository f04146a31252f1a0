"""How far the port's default generation falls from the JAX package's.

Both evaluators at their defaults — the JAX one with ``use_pallas=False``
(per-source bfloat16-rounded gate convs, bfloat16 gate math), the port's
with its fused kernel's math (float32 sums and gates) — on the CPU, with
the bundled ``3,48,96,192`` color weights, on the population of a NEAT
checkpoint (160x120, its own preset, 20+2 rollout, bfloat16)::

    python3 tests/port_divergence.py [gallery/circles_color/neat-checkpoint-30 ...]

Prints both fitness vectors, max / mean |Δfitness|, whether ``best_idx``
agrees and the rank correlation.  A measurement, not a test: it takes about
a minute a checkpoint.
"""

import copy
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402
import torch  # noqa: E402

from evolutionary_illusion_generator_tpu.evolution.evaluator import (  # noqa: E402
    EvalConfig as JaxEvalConfig,
    GenerationEvaluator as JaxEvaluator,
)
from evolutionary_illusion_generator_tpu.models.prednet import loader as jax_loader  # noqa: E402
from evolutionary_illusion_generator_tpu.neat.checkpoint import (  # noqa: E402
    restore_checkpoint as jax_restore,
)
from evolutionary_illusion_generator_tpu_torch.evolution import (  # noqa: E402
    EvalConfig,
    GenerationEvaluator,
)
from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (  # noqa: E402
    load_or_init,
)
from evolutionary_illusion_generator_tpu_torch.neat.checkpoint import (  # noqa: E402
    restore_checkpoint,
)

CHANNELS = (3, 48, 96, 192)


def _ranks(x):
    return np.argsort(np.argsort(x))


def compare(ckpt: str) -> None:
    jpop, tpop = jax_restore(ckpt), restore_checkpoint(ckpt)
    jitems, titems = list(jpop.population.items()), list(tpop.population.items())
    assert [k for k, _ in jitems] == [k for k, _ in titems]
    jparams = jax_loader.load_params(jax_loader.bundled_weights_path(CHANNELS))
    t0 = time.time()
    jeval = JaxEvaluator(JaxEvalConfig(score_backend="numpy", program_cache=False), jparams,
                         jpop.config)
    jscores = np.asarray(jeval(copy.deepcopy(jitems)))
    t1 = time.time()
    teval = GenerationEvaluator(EvalConfig(), load_or_init(None, CHANNELS, device="cpu"),
                                tpop.config, device="cpu")
    tscores = np.asarray(teval(copy.deepcopy(titems)))
    t2 = time.time()
    d = np.abs(tscores - jscores)
    jbest, tbest = jeval.last_results["best_idx"], teval.last_results["best_idx"]
    print(f"{ckpt}: population {len(jitems)}, jax {t1 - t0:.1f} s, port {t2 - t1:.1f} s")
    print("  jax  ", np.round(jscores, 5).tolist())
    print("  port ", np.round(tscores, 5).tolist())
    print(f"  |dfitness| max {d.max():.6g} mean {d.mean():.6g}; fitness "
          f"{jscores.min():.5f}..{jscores.max():.5f}; best_idx jax {jbest} port {tbest} "
          f"({'agree' if jbest == tbest else 'DIFFER'}); rank correlation "
          f"{np.corrcoef(_ranks(jscores), _ranks(tscores))[0, 1]:.4f}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    for path in sys.argv[1:] or [str(REPO / "gallery/circles_color/neat-checkpoint-30")]:
        compare(path)
