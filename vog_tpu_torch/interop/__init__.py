"""Weight conversion: from the JAX package's flax param tree
(``from_jax``) and from its ``transformers`` BERT-SRL tagger
(``from_transformers``)."""
