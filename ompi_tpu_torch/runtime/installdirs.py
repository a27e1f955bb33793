"""installdirs: where the installation's pieces live.

Port of the reference's runtime/installdirs.py, a re-design of
opal/mca/installdirs (ref: installdirs.h:74-87 — a
component stack layering configure-time defaults under env-var and
config overrides, consumed by show_help/paths/tools).  A Python
package's layout collapses the component stack to: package-derived
defaults, overridden by ``TPUMPI_<FIELD>`` environment variables
(the installdirs/env component's contract).

    from ompi_tpu_torch.runtime import installdirs
    installdirs.get("prefix")    # repo/venv root of the install
    installdirs.expand("${datadir}/help")  # ${field} interpolation
"""

from __future__ import annotations

import os
import sys
from typing import Dict


def _defaults() -> Dict[str, str]:
    """The checkout's layout: the native sources stay under
    ``native/`` and the kernel sources under the package's
    ``kernels/csrc``; what is compiled from them goes under
    ``build/ompi_tpu_torch/`` (pkglibdir)."""
    import ompi_tpu_torch

    pkgdir = os.path.dirname(os.path.abspath(ompi_tpu_torch.__file__))
    prefix = os.path.dirname(pkgdir)
    return {
        "prefix": prefix,
        "bindir": os.path.dirname(os.path.abspath(sys.executable)),
        "libdir": pkgdir,
        "includedir": os.path.join(prefix, "native"),
        "datadir": os.path.join(pkgdir, "kernels", "csrc"),
        "sysconfdir": os.path.join(prefix, "etc"),
        "localstatedir": os.environ.get("TMPDIR", "/tmp"),
        "pkglibdir": os.path.join(prefix, "build", "ompi_tpu_torch"),
        "docdir": os.path.join(prefix, "docs"),
    }


def _raw_dirs() -> Dict[str, str]:
    out = {}
    for field, default in _defaults().items():
        out[field] = os.environ.get(f"TPUMPI_{field.upper()}", default)
    return out


def all_dirs() -> Dict[str, str]:
    """Every field, env overrides applied (TPUMPI_PREFIX etc) and
    ${field} references expanded — an override may reference other
    fields ('${prefix}/share'), so consumers always get a usable
    path."""
    dirs = _raw_dirs()
    for _ in range(4):
        changed = False
        for field, value in dirs.items():
            for ref, rv in dirs.items():
                token = "${" + ref + "}"
                if token in value and ref != field:
                    value = value.replace(token, rv)
            if value != dirs[field]:
                dirs[field] = value
                changed = True
        if not changed:
            break
    return dirs


def get(field: str) -> str:
    dirs = all_dirs()
    if field not in dirs:
        raise KeyError(
            f"unknown installdirs field {field!r} "
            f"(have: {', '.join(sorted(dirs))})")
    return dirs[field]


def expand(template: str) -> str:
    """${field} interpolation (the opal_install_dirs_expand
    contract)."""
    out = template
    dirs = all_dirs()  # already fully expanded
    for field, value in dirs.items():
        out = out.replace("${" + field + "}", value)
    return out
