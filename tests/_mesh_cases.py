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
# the vocab-parallel embedding, head and loss (tests/test_torch_tp_vocab.py):
# case -> (tiny configuration, its changed fields): an untied head, a stub
# frontend (embeddings in, the head still split), a tied head (embed.T)
VOCAB_CASES = {"qwen2-72b": ("qwen2-72b", {}),
               "musicgen-medium": ("musicgen-medium", {}),
               "qwen2-72b-tied": ("qwen2-72b", {"tie_embeddings": True})}
# Megatron-SP (tests/test_torch_tp_seq.py): attention and MLP, a hybrid's
# two mixers and their norms, the SSM, MLA, attention beside the
# expert-parallel MoE, a stub frontend (its adapter's output split), each
# under seq_shard_activations
SEQ_ARCHS = ("qwen2-72b", "hymba-1_5b", "mamba2-2_7b", "minicpm3-4b",
             "dbrx-132b", "musicgen-medium")
SEQ_CASES = {f"{a}-sp": (a, {"seq_shard_activations": True})
             for a in SEQ_ARCHS}
LABEL_SEED, LABEL_IDS = 7, 97         # the training batches' labels


def case_config(case: str) -> tuple:
    """(tiny configuration, changed fields) of a case of ``VOCAB_CASES`` or
    ``SEQ_CASES``, or of a configuration's own name."""
    return {**VOCAB_CASES, **SEQ_CASES}.get(case, (case, {}))
