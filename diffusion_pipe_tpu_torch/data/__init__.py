"""Data pipeline: media preprocessing, bucketing, the latent and
text-embedding cache, the dataset hierarchy and the loader.

The port's copy of diffusion_pipe_tpu/data/. The data path stays on the
host: media decode to numpy, the cache stores tensors in safetensors
shards, and batches come out as CPU torch tensors that the trainer moves to
the card.
"""
