"""tpumpi_info: dump the build/component/parameter inventory.

Port of the reference's tools/info.py, a re-design of
ompi/tools/ompi_info (ref: ompi_info dumps every
framework's components plus all MCA variables with value + source;
``--parsable`` emits the machine format MTT-style harnesses consume).

    python -m ompi_tpu_torch.tools.info                  # overview
    python -m ompi_tpu_torch.tools.info --param all all  # every variable
    python -m ompi_tpu_torch.tools.info --param coll all --parsable
    python -m ompi_tpu_torch.tools.info --pvars

The overview prints torch's version where the reference prints jax's.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

from ompi_tpu_torch.mca.base import frameworks
from ompi_tpu_torch.mca.params import (SOURCE_DEFAULT, SOURCE_ENV, SOURCE_FILE,
                                 SOURCE_OVERRIDE, registry)

_SOURCE_NAMES = {
    SOURCE_DEFAULT: "default",
    SOURCE_FILE: "file",
    SOURCE_ENV: "environment",
    SOURCE_OVERRIDE: "override",
}


def _import_all_components() -> None:
    """Load every module that registers components/vars, mirroring
    ompi_info's open-all-frameworks pass."""
    import ompi_tpu_torch.btl.inproc  # noqa: F401
    import ompi_tpu_torch.btl.self_btl  # noqa: F401
    import ompi_tpu_torch.btl.shm  # noqa: F401
    import ompi_tpu_torch.btl.tcp  # noqa: F401
    import ompi_tpu_torch.coll  # noqa: F401
    import ompi_tpu_torch.pml.monitoring  # noqa: F401
    import ompi_tpu_torch.pml.ob1  # noqa: F401
    import ompi_tpu_torch.osc.window  # noqa: F401


def list_components(parsable: bool) -> List[str]:
    out = []
    for fw in frameworks.all():
        comps = sorted(fw._components.values(), key=lambda c: -c.priority)
        if parsable:
            for c in comps:
                out.append(f"mca:{fw.name}:{c.name}:priority:{c.priority}")
        else:
            names = ", ".join(f"{c.name} (pri {c.priority})" for c in comps)
            out.append(f"  {fw.project}:{fw.name}: {names or '(none)'}")
    return out


def list_params(fw_filter: str, comp_filter: str, parsable: bool
                ) -> List[str]:
    out = []
    for v in registry.all_vars():
        if fw_filter != "all" and v.framework != fw_filter:
            continue
        if comp_filter != "all" and v.component != comp_filter:
            continue
        src = _SOURCE_NAMES.get(v.source, "?")
        if parsable:
            out.append(f"mca:{v.framework}:{v.component or 'base'}:param:"
                       f"{v.full_name}:value:{v.value}:source:{src}")
        else:
            out.append(f"  {v.full_name} = {v.value!r}  "
                       f"[{v.typ.__name__}, {src}]"
                       + (f"  # {v.help}" if v.help else ""))
    return out


def list_pvars(parsable: bool) -> List[str]:
    out = []
    for p in registry.all_pvars():
        if parsable:
            out.append(f"mca:{p.framework}:{p.component or 'base'}:pvar:"
                       f"{p.full_name}:class:{p.var_class}")
        else:
            out.append(f"  {p.full_name} [{p.var_class}]"
                       + (f"  # {p.help}" if p.help else ""))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpumpi_info",
        description="Inventory of frameworks, components and parameters")
    ap.add_argument("--param", nargs=2, metavar=("FRAMEWORK", "COMPONENT"),
                    help="show variables ('all all' for everything)")
    ap.add_argument("--pvars", action="store_true",
                    help="show performance variables")
    ap.add_argument("--parsable", action="store_true")
    args = ap.parse_args(argv)

    _import_all_components()
    lines: List[str] = []
    import ompi_tpu_torch
    from ompi_tpu_torch.runtime import installdirs
    if not args.parsable:
        lines.append(f"ompi_tpu_torch version: {ompi_tpu_torch.__version__}")
        try:
            import torch
            lines.append(f"torch: {torch.__version__}")
        except Exception:
            pass
        for field, value in sorted(installdirs.all_dirs().items()):
            lines.append(f"{field}: {value}")
    else:
        lines.append(f"version:{ompi_tpu_torch.__version__}")
        for field, value in sorted(installdirs.all_dirs().items()):
            lines.append(f"installdirs:{field}:{value}")

    if args.param:
        if not args.parsable:
            lines.append("Parameters:")
        lines += list_params(args.param[0], args.param[1], args.parsable)
    elif args.pvars:
        if not args.parsable:
            lines.append("Performance variables:")
        lines += list_pvars(args.parsable)
    else:
        if not args.parsable:
            lines.append("Components:")
        lines += list_components(args.parsable)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
