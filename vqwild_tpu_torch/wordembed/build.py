"""Class-name word-embedding builder (reference word_embed/ side tree).

Host copy of vqwild_tpu/wordembed/build.py.

Upstream runs per-model scripts (GloVe/fastText/word2vec via gensim, ELMo via
allennlp) that lowercase + tokenize each class name, apply hand-fixed
substitutions for out-of-vocabulary tokens, mean-pool the token vectors, and
emit ``{label: vector}`` JSON (wordembed_glove.py:16-55). gensim/allennlp are
not available offline, so this builder takes any token→vector table — e.g. a
standard GloVe/fastText ``.txt``/``.vec`` file via ``load_vector_table`` —
and reproduces the same tokenize→substitute→mean-pool→JSON pipeline.

OOV substitutions (wordembed_glove.py:27-42): misspellings in the ActivityNet
class names plus compound words split into vocabulary tokens. Tokens still
missing from the table are skipped with a warning (upstream: "pass word").

Shipped decision (README divergence #11): GloVe-default, token-table-only.
Upstream's default ELMo blob (wordembed_elmo_d1024.json) is missing from the
reference itself (.MISSING_LARGE_BLOBS), and ELMo is contextual — it needs
allennlp + model weights, not a token table — so a contextual path is
intentionally out of scope; externally produced ``{label: vector}`` JSONs
(including ELMo ones) load unchanged via ``--semantic_json``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from vqwild_tpu_torch.core.logging import get_logger

log = get_logger("wordembed")

# upstream's hand-fixed OOV token rewrites (wordembed_glove.py:27-42,
# wordembed_word2vec.py:27-52): {trigger_token: replacement_token_list or
# {old: new} single swap}
DEFAULT_SUBSTITUTIONS: Dict[str, List[str]] = {
    "mooping": ["cleaning"],  # misspelling of "mopping"
    "slacklining": ["slackline"],
    "powerbocking": ["spring", "stilts"],
    "forniture": ["furniture"],  # misspelling
    "jack-o-lanterns": ["carving", "halloween", "pumpkin"],
    "plataform": ["platform"],  # misspelling
    "blow-drying": ["blow", "drying", "hair"],
    "rock-paper-scissors": ["rock", "paper", "scissors"],
}


def tokenize_label(label: str, substitutions: Optional[Dict[str, List[str]]] = None):
    subs = DEFAULT_SUBSTITUTIONS if substitutions is None else substitutions
    tokens = [t.lower() for t in label.split()]
    out: List[str] = []
    for t in tokens:
        if t in subs:
            out.extend(subs[t])
        else:
            out.append(t)
    return out


def load_vector_table(path: str, dim: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Parse a GloVe/fastText-style text file: ``token v1 v2 ...`` per line
    (a leading ``count dim`` header line is skipped)."""
    table: Dict[str, np.ndarray] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            parts = line.rstrip().split(" ")
            if i == 0 and len(parts) == 2:
                continue  # fastText .vec header
            token = parts[0]
            vec = np.asarray(parts[1:], dtype=np.float32)
            if dim is not None and len(vec) != dim:
                continue
            table[token] = vec
    return table


def build_class_embeddings(
    labels: Sequence[str],
    vectors: Dict[str, np.ndarray],
    substitutions: Optional[Dict[str, List[str]]] = None,
) -> Dict[str, List[float]]:
    """→ {label: mean-pooled token vector} (upstream wrap_sentence)."""
    out: Dict[str, List[float]] = {}
    dim = len(next(iter(vectors.values())))
    for label in labels:
        acc = np.zeros(dim, np.float32)
        n = 0
        for token in tokenize_label(label, substitutions):
            v = vectors.get(token)
            if v is None:
                log.warning("pass word: %s (label %r)", token, label)
                continue
            acc += v
            n += 1
        out[label] = (acc / (n + 1e-10)).tolist()
    return out


def write_embeddings_json(embeds: Dict[str, List[float]], path: str):
    with open(path, "w") as f:
        json.dump(embeds, f)


def main(argv=None):
    """CLI parity with the reference's runnable word_embed/*.py scripts
    (wordembed_glove.py etc.): build {label: vector} JSON for the ActivityNet
    label set from any GloVe/fastText-style text vector file."""
    import argparse

    from vqwild_tpu_torch.data.labels import activitynet_labels

    p = argparse.ArgumentParser(description="build class word embeddings")
    p.add_argument("--vectors", required=True,
                   help="GloVe/fastText text file: 'token v1 v2 …' per line")
    p.add_argument("--out", default="wordembed.json")
    p.add_argument("--dim", type=int, default=None,
                   help="skip vector lines whose dim differs (fastText .vec)")
    args = p.parse_args(argv)

    labels = activitynet_labels()
    vectors = load_vector_table(args.vectors, dim=args.dim)
    embeds = build_class_embeddings(labels, vectors)
    write_embeddings_json(embeds, args.out)
    dim = len(next(iter(embeds.values())))
    print(f"wrote {len(embeds)} labels x d{dim} -> {args.out}")


if __name__ == "__main__":
    main()
