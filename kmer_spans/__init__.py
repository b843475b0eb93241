"""kmer_spans — k-mer span-finding engine on JAX accelerators.

A from-scratch JAX/XLA re-design of the capabilities of
lmjakt/kmer_spans (see SURVEY.md for the behavior contract).
"""

from .encoding import MAX_K, NUC, PackedSeq, all_kmers, code_to_kmer, kmer_to_code, pack

__version__ = "0.1.0"
