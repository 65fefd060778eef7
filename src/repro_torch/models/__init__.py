"""LM model zoo: shared layers + the attention family.

Twin of :mod:`repro.models` for ``block_kind="attn"``: ``common``,
``attention`` (GQA / MQA, MLA), ``moe`` and ``transformer``. The Mamba2,
RWKV6, Whisper and Zamba2 families are not ported yet (ROADMAP Queue 1
item 12a-ii).
"""

from repro_torch.models import attention, common, moe, transformer  # noqa: F401
