"""retrieval_scaling_tpu_torch — the PyTorch + CUDA port of retrieval_scaling_tpu.

The JAX package beside it is the reference: every module here keeps the
name and layout of its counterpart there, so ``ops/flash_attention.py``
ports ``retrieval_scaling_tpu/ops/flash_attention.py`` and so on. This
package imports ``torch`` and never ``jax``; host-only modules that the
JAX package also has (``config.py``, ``data/``) are copies, so that a run
on the GPU never imports the JAX package.

Layering (bottom to top):
  csrc/      hand-written CUDA kernels for Hopper (sm_90a), built at first
             use by ``ops/_build.py`` into the repo's ``build/`` directory.
  ops/       kernel wrappers with their plain PyTorch versions, exact top-k.
  models/    Contriever/BERT encoder, GPT-NeoX (Pythia) reader, HF I/O.
  index/     Flat (bf16 or SQ8), IVF-Flat and IVF-PQ indexes on one device.
  data/      host-side data layer (copies of the JAX package's modules).
  utils/     host-side copies: text normalization, the Porter stemmer,
             MinHash dedup, decontamination, result-path lists.
  search/    query encoding, the offline search driver, BM25, the
             multi-source merge and post-processing.
  evals/     retrieval-augmented perplexity and its calibration form.
  pipeline/  config-driven task sequencer.
"""

__version__ = "0.1.0"
