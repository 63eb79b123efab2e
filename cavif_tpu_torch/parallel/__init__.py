"""Parallel runtime of the PyTorch/CUDA port: batch (data) parallelism.

Maps the reference's parallelism levels to this framework: rayon par_iter
over files -> encode_batch thread pool (or the hybrid card + host
scheduler); rayon::join color/alpha -> two stream threads in pipeline.py;
rav1e tile threads -> parallel native tile encodes (av1/encoder.py); a
batch of same-shaped images -> batched device programs
(encode_batch_sharded, plane_mode_search_batch); a (data = images,
tile = block rows) mesh of torch.distributed ranks -> GSPMD's shardings
(parallel/mesh.py: each rank computes its images over its band of
superblock rows plus a halo, and an all_gather replicates the result).
"""

from .batch import BatchResult, encode_batch, plane_mode_search_batch

__all__ = ["BatchResult", "encode_batch", "plane_mode_search_batch"]
