"""LM model zoo: shared layers + the dense attention family.

Twin of :mod:`repro.models` for the dense GQA / MQA decoder (``common``,
``attention``, ``transformer``). The MoE, Mamba2, RWKV6, Whisper and
Zamba2 families are not ported yet (ROADMAP Queue 1 item 12a).
"""

from repro_torch.models import attention, common, transformer  # noqa: F401
