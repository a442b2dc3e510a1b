"""Writes the semantic tokenizer of the repository's stage recipe to
persist/hubert_r5_stage.npz, so that the PyTorch port (which has no JAX)
can tokenise prompts into the ids the banked Semantic LM was trained on.

The recipe (examples/train_audiolm_stages.py) builds its HuBERT from
jax.random.PRNGKey(1) at dim 256, 3 layers, 4 heads, output layer 3, and
sets its centres to results_quality/audiolm_r5/kmeans.npy; it never saved
the model. This script rebuilds it with the JAX package's own code and
saves it in the JAX checkpoint format (float32, with its config), which
`audiolm_pytorch_tpu_torch.models.hubert.load_hubert_with_kmeans` reads.

    JAX_PLATFORMS=cpu python -m tools.persist_hubert_stage
"""
from __future__ import annotations

import argparse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from audiolm_pytorch_tpu.models.hubert import HubertWithKmeans
from audiolm_pytorch_tpu.nn.module import evolve
from audiolm_pytorch_tpu.training.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parents[1]
# the recipe's HuBERT (examples/train_audiolm_stages.py:161-163) and its key
CONFIG = dict(dim=256, num_layers=3, heads=4, output_layer=3, codebook_size=100)
KEY = 1


def build(kmeans=ROOT / "results_quality" / "audiolm_r5" / "kmeans.npy"):
    """The recipe's HubertWithKmeans, as the JAX package builds it."""
    w2v = HubertWithKmeans(**CONFIG, key=jax.random.PRNGKey(KEY))
    return evolve(w2v, cluster_centers=jnp.asarray(np.load(kmeans)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / "persist" / "hubert_r5_stage.npz"))
    args = parser.parse_args()
    save_checkpoint(args.out, build(), config=CONFIG, kind="hubert_with_kmeans")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
