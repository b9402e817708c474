"""Box-drawing table pretty-printers for args / metrics / feature summaries.

Capability parity with the reference's utils/print_util.py:16-210 (unicode
tables for argparse args, metric dicts, dataframes) without pandas coupling.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Optional, Sequence


def _cell(x: Any) -> str:
    if isinstance(x, float):
        return f"{x:.6g}"
    return str(x)


def format_table(rows: Sequence[Sequence[Any]],
                 headers: Optional[Sequence[str]] = None,
                 title: Optional[str] = None) -> str:
    rows = [[_cell(c) for c in r] for r in rows]
    ncol = max((len(r) for r in rows), default=0)
    if headers:
        ncol = max(ncol, len(headers))
    rows = [r + [""] * (ncol - len(r)) for r in rows]
    head = list(headers) + [""] * (ncol - len(headers)) if headers else None
    widths = [0] * ncol
    for r in ([head] if head else []) + rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))

    def hline(l: str, m: str, r: str) -> str:
        return l + m.join("─" * (w + 2) for w in widths) + r

    def fmt_row(r: Sequence[str]) -> str:
        return "│" + "│".join(f" {c:<{w}} " for c, w in zip(r, widths)) + "│"

    lines: List[str] = []
    total = sum(widths) + 3 * ncol - 1
    if title:
        lines.append("┌" + "─" * total + "┐")
        lines.append("│" + f"{title:^{total}}" + "│")
        lines.append(hline("├", "┬", "┤"))
    else:
        lines.append(hline("┌", "┬", "┐"))
    if head:
        lines.append(fmt_row(head))
        lines.append(hline("├", "┼", "┤"))
    for r in rows:
        lines.append(fmt_row(r))
    lines.append(hline("└", "┴", "┘"))
    return "\n".join(lines)


def print_table(rows: Sequence[Sequence[Any]],
                headers: Optional[Sequence[str]] = None,
                title: Optional[str] = None) -> None:
    print(format_table(rows, headers, title))


def print_kv(d: Mapping[str, Any], title: Optional[str] = None) -> None:
    print_table([[k, v] for k, v in d.items()], headers=["key", "value"], title=title)


def print_args(args: Any, title: str = "Arguments") -> None:
    print_kv(vars(args) if hasattr(args, "__dict__") else dict(args), title=title)
