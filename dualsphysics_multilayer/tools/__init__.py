"""Post-processing tool suite (the reference's external toolchain rebuilt).

The reference ships GenCase, PartVTK, PartVTKOut, MeasureTool, IsoSurface,
ComputeForces, FloatingInfo, BoundaryVTK, TracerParts, FlowTool and
BIFileInfo as closed binaries (`/root/reference/bin/`, help dumps in
`doc/help/*.out`, SURVEY §1 "External toolchain").  Each has a native
rebuild here, runnable as

    python -m dualsphysics_multilayer.tools.<name> <flags>
    dsphtools <name> <flags>

with the same flag grammar the help dumps document.  GenCase's equivalent
lives in `..io.gencase` (case XML + geometry lattice -> case .bi4).
"""

from __future__ import annotations

import sys

TOOLS = ("partvtk", "partvtkout", "measuretool", "isosurface",
         "computeforces", "floatinginfo", "boundaryvtk", "tracerparts",
         "flowtool", "bifileinfo", "readswash")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("tools:", ", ".join(TOOLS))
        return 0
    name = argv[0].lower()
    if name not in TOOLS:
        print(f"dsphtools: unknown tool '{name}' (have: {', '.join(TOOLS)})",
              file=sys.stderr)
        return 2
    import importlib
    mod = importlib.import_module(f".{name}", __package__)
    return mod.main(argv[1:])
