"""Dispatcher: ``python -m ngsbits_tpu <ToolName> [args...]``."""

from __future__ import annotations

import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from .tools import TOOL_MODULES, get_tool

    if not argv or argv[0] in ("-h", "--help"):
        print("ngsbits-tpu — accelerator-backed NGS QC/processing toolkit")
        print()
        print("Usage: python -m ngsbits_tpu <ToolName> [args...]")
        print()
        print("Available tools:")
        for name in sorted(TOOL_MODULES):
            print(f"  {name}")
        return 0

    name = argv[0]
    try:
        tool_cls = get_tool(name)
    except KeyError:
        print(f"Error: unknown tool '{name}'", file=sys.stderr)
        return 1
    tool = tool_cls()
    if name != tool.name:
        tool.name = name
    return tool.execute(argv[1:])


if __name__ == "__main__":
    from .utils.backend import enable_compilation_cache
    enable_compilation_cache()
    sys.exit(main())
