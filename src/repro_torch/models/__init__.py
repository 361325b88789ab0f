"""The LM stack's model modules: parameter schema, layers, attention (GQA,
MLA, cross), MoE and the transformer."""
