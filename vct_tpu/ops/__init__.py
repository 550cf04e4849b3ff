"""Hand-written kernels for the frame's hot path.

  binrast_pallas — binned primary-visibility raycast (Pallas-Triton),
                   the camera pass's raycast on a GPU (render/fast.py)

Each kernel has a plain jax.numpy oracle (render/gbuffer.py for the
raycast) and is parity-tested against it in interpret mode on the CPU.
Everything else — voxelization, mips, dense marches, shading taps,
material fetch — is plain XLA, which compiles for the GPU as it stands.
"""
