"""Packed rank-class screening tables and their integer screen scores.

The span screen needs only a SOUND UPPER BOUND on each position's rank
(the max-plus scan is monotone in its inputs, so overestimating scores
can only add candidate blocks, never lose a region; candidates are
replayed exactly from integer mass by the host finisher).  Ranks
quantized to 16 levels pack 8 entries per int32 word, so a 4^k table
shrinks to 4^k/8 words (8 K words, 32 KB, at k=8) and the per-position
lookup is a plain gather ``words[code >> 3]`` plus a nibble extract.

Reference parity: this accelerates the scoring gather feeding the scan
of kmer_regions (src/kmer_spans.c:268); emitted spans still come from
exact integer mass via the finisher (spans/pipeline.py), so region
output is unchanged.
"""

from __future__ import annotations

import jax.numpy as jnp

CLASS_BITS = 4
CLASS_LEVELS = 16          # ranks quantized to ceil(rank*16)/16 upper edges
WORD_ENTRIES = 32 // CLASS_BITS  # 8 nibbles per int32 word
#: the packed class screen serves k up to this; above it the spans
#: pipeline takes the sort screen (ops/sortscreen.py), which needs no
#: 4^k table on the device
CLASS_SCREEN_MAX_K = 9


#: integer screening scale: screen scores live in units of 2^-12 rank.
#: Within-block sums are bounded by 8192 * (4096 + slack) < 2^27 (int32
#: safe); the cross-block composition runs in int64 on the host (exact to
#: genome sizes ~1e12 bases).
SCREEN_SCALE = 4096


def screen_thr_q(thr):
    """Sound integer threshold: thr_q <= SCREEN_SCALE * thr, always.

    f32 multiply rounds to nearest (|err| <= 0.5 ulp < 1 here), so
    floor(thr*4096) - 1 can never exceed the true product.
    """
    import jax.numpy as jnp

    return jnp.floor(thr * SCREEN_SCALE).astype(jnp.int32) - 1


def class_scores_int(cls_nibble, thr_q):
    """Integer upper-bound screen score (units of 2^-12 rank).

    s_int = (cls+1)*256 + 3 - thr_q  >=  SCREEN_SCALE * (rank - thr)
    for any true rank in the class: (cls+1)/16 >= rank up to one f32
    rounding of the table build (< 2^-11 scaled units), covered by the +3
    together with thr_q's -1 slack.  Monotonicity of the max-plus scan
    then makes every block summary an exact-integer UPPER bound on the
    true scaled score — no floating-point margins anywhere.
    """
    return (cls_nibble + 1) * (SCREEN_SCALE // CLASS_LEVELS) + 3 - thr_q


def fine_class_table(mass, total_f32):
    """int16 4096-level rank-upper-bound table (any k).

    tab[c] = floor(rank_f32 * 4096) + 1 >= 4096*rank - 2^-11, gathered
    per position.  Screen score: tab[codes] + 2 - thr_q (same soundness
    slack as class_scores_int).
    """
    import jax.numpy as jnp

    rank = mass.astype(jnp.float32) / jnp.maximum(total_f32, 1.0)
    return (
        jnp.clip((rank * SCREEN_SCALE).astype(jnp.int32), 0, SCREEN_SCALE)
        + 1
    ).astype(jnp.int16)


def fine_scores_int(tab_vals, thr_q):
    """Integer screen scores from a fine_class_table gather."""
    return tab_vals.astype(jnp.int32) + 2 - thr_q


def class_table_from_mass(mass, total_f32):
    """Packed rank-upper-bound classes from integer cumulative mass.

    class[c] = min(15, floor(rank_f32 * 16)) with rank = mass/total; the
    screening score uses the class's UPPER edge (class+1)/16 plus a small
    slack for the f32 division, making s_ub >= s_true always.  Returns
    int32 [4^k / 8] packed words (entry e at bits 4*e).
    """
    rank = mass.astype(jnp.float32) / jnp.maximum(total_f32, 1.0)
    cls = jnp.clip((rank * CLASS_LEVELS).astype(jnp.int32), 0,
                   CLASS_LEVELS - 1)
    w = cls.reshape(-1, WORD_ENTRIES)
    shifts = jnp.arange(WORD_ENTRIES, dtype=jnp.int32) * CLASS_BITS
    return jnp.sum(w << shifts[None, :], axis=1, dtype=jnp.int32)


def class_nibbles(words, codes):
    """Per-position 4-bit classes: ``words[codes >> 3]``, nibble
    ``codes & 7``.  codes must lie in [0, 8 * len(words))."""
    w = words[codes >> 3]
    return (w >> ((codes & (WORD_ENTRIES - 1)) * CLASS_BITS)) \
        & (CLASS_LEVELS - 1)


def class_scores(cls_nibble, thr):
    """Sound upper-bound screening score for a 4-bit rank class."""
    return (cls_nibble.astype(jnp.float32) + 1.0) * (1.0 / CLASS_LEVELS) \
        - thr + 1e-5


def class_screen_scores(words, codes, thr):
    """Upper-bound screening scores for codes via the packed class table."""
    return class_scores(class_nibbles(words, codes), thr)
