"""The SUCCESS/FAILURE rule the apps print — a copy of the ``Verdict``
of ``hpc_patterns_tpu/harness/verdict.py`` (the reference's binaries are
their own tests: they check their claim and exit 0/1)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Verdict:
    success: bool
    messages: tuple[str, ...]

    @property
    def exit_code(self) -> int:
        return 0 if self.success else 1

    def summary_line(self) -> str:
        return "SUCCESS" if self.success else "FAILURE"
