"""The cases of the mesh tests, shared by the tests of the port and the
reference's side (``_jax_mesh_ref.py``); no imports, so either side can
load it."""

MOE_ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")
MOE_DTYPES = ("float32", "bfloat16")
MOE_CAPACITY = ("config", "tight")     # tight: capacity factor 0.5 binds
MOE_MESHES = ((1, 2), (2, 2), (1, 4))
MOE_SHAPE = (4, 16)                    # (B, S) of the MoE tests' tokens
MODEL_SHAPE = (4, 8)                   # prefill tokens; then decode steps
DECODE_STEPS = 4
PSUM_SHAPE = (4, 256)                  # one row per rank
# tensor-parallel attention and MLP (tests/test_torch_tp.py): GQA with QKV
# bias, a stub frontend (embeddings in), a dense layer beside a MoE layer
# with a shared expert, attention beside the expert-parallel MoE
TP_ARCHS = ("qwen2-72b", "musicgen-medium", "llama4-maverick-400b-a17b",
            "dbrx-132b")
TP_MESHES = MOE_MESHES
TP_DTYPES = MOE_DTYPES
# tensor-parallel token mixers (tests/test_torch_tp_mixers.py): the SSM
# (attention-free), a hybrid's attention beside its SSM, MLA
TP_MIXER_ARCHS = ("mamba2-2_7b", "hymba-1_5b", "minicpm3-4b")
