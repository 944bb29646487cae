"""Offline dataset construction (counterpart of vog_tpu/dcode/).

SRL-tagging caption sentences (a rule tagger, or BERT-SRL on the card
through the port's own BERT, WordPiece tokenizer and flash kernel),
aligning the arguments with ActivityNet-Entities boxes, writing the
annotation files and contrastive dicts, and building a GT5 store from a
P100 one (``python -m vog_tpu_torch.dcode.pipeline``).  The stages other
than the BERT tagger and its trainer are host work on numpy.
"""
