"""Parallelism on `torch.distributed`: the data/model mesh, tensor-parallel
forward, sharded paged serving, ring attention and the GPipe ring.

Counterpart of `diffusion_llm_rs_tpu/parallel/`. One process drives one
device; a `Mesh` (`mesh.py`) names the axes of the processes and carries a
`DeviceMesh` whose groups run the collectives that JAX's `shard_map` bodies
call: `psum` is `all_reduce`, `ppermute` is `batch_isend_irecv`, and the
expert-parallel all-to-all pair is `all_to_all_single`. NCCL carries them on
the card (the default), gloo when the caller asks for the CPU. Every rank
runs the same program on its own shard, as every device of a JAX mesh does.

JAX's `utils/platform.py` (pinning JAX's platform) has no counterpart: every
entry point of the port takes its `device` explicitly.
"""
