"""The paper's own model family (§C.1 / Table 7) as named configs,
counterpart of ``repro.configs.moe_paper``.

These use :mod:`repro_torch.models.paper_lm` (LSTM -> MoE -> LSTM), not
the transformer stack.  Vocab defaults to 32k wordpieces as in the
reference; the 1-Billion-Word vocabulary of the paper is 793,471 words
(pass ``vocab_size=793_471``).  The hierarchical rows (``moe-*-h``,
Appendix B) build :mod:`repro_torch.core.hierarchical`'s two-level MoE,
k = 2 at each level.
"""
from __future__ import annotations

from repro_torch.models.paper_lm import PaperLMConfig

PAPER_VOCAB = 32_000


def paper_config(name: str, vocab_size: int = PAPER_VOCAB) -> PaperLMConfig:
    table = {
        # Table 7 rows (flat then hierarchical), k=4 flat / k=2 per level.
        "moe-4":      dict(variant="moe", n_experts=4, k=4),
        "moe-32":     dict(variant="moe", n_experts=32, k=4),
        "moe-256":    dict(variant="moe", n_experts=256, k=4),
        "moe-256-h":  dict(variant="moe", n_experts=256,
                           hierarchical=(16, 16)),
        "moe-1024-h": dict(variant="moe", n_experts=1024,
                           hierarchical=(16, 64)),
        "moe-4096-h": dict(variant="moe", n_experts=4096,
                           hierarchical=(16, 256)),
        # Computationally-matched baselines (§C.1).
        "moe-1-wide": dict(variant="moe_1_wide"),
        "moe-1-deep": dict(variant="moe_1_deep"),
        "4xlstm-512": dict(variant="lstm_4x"),
        "lstm-2048-512": dict(variant="lstm_2048_512"),
    }
    if name not in table:
        raise KeyError(f"unknown paper config {name!r}; have {sorted(table)}")
    return PaperLMConfig(vocab_size=vocab_size, **table[name])


PAPER_CONFIGS = ("moe-4", "moe-32", "moe-256", "moe-256-h", "moe-1024-h",
                 "moe-4096-h", "moe-1-wide", "moe-1-deep", "4xlstm-512",
                 "lstm-2048-512")
