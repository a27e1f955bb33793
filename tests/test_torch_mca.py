"""The MCA variable system and component selection through the port
(ompi_tpu_torch/mca: ``params`` and ``base``; ``runtime/installdirs``;
``tools/info``), with the reference beside it.

The analogs of tests/test_mca.py's thirteen tests: precedence
(defaults < files < env < override), size suffixes, bool coercion,
param files, pvar counters, framework selection (priority, user
exclusion, select_all's order), ``parse_mca_args``, the schizo
``OMPI_MCA_*`` spelling, installdirs and info.  Each test body runs
through both packages (ids ``port`` and ``ref``) and must give the
same result.  Variable and framework names are this file's own
(``tpt_*``), so the reference's test file, run in the same process,
never sees them.
"""

import os
import types

import pytest


def _pkg(name):
    if name == "port":
        from ompi_tpu_torch.mca import base, params
        from ompi_tpu_torch.runtime import installdirs
        from ompi_tpu_torch.tools import info
    else:
        from ompi_tpu.mca import base, params
        from ompi_tpu.runtime import installdirs
        from ompi_tpu.tools import info
    return types.SimpleNamespace(name=name, base=base, params=params,
                                 installdirs=installdirs, info=info)


@pytest.fixture(params=["port", "ref"])
def pkg(request):
    return _pkg(request.param)


def test_var_default_and_env(pkg, monkeypatch):
    params = pkg.params
    var = params.registry.register("tpt", "comp", "alpha", 7, int,
                                   help="x")
    assert var.value == 7
    assert var.source == params.SOURCE_DEFAULT

    monkeypatch.setenv(params.ENV_PREFIX + "tpt_comp_alpha", "42")
    params.registry.refresh()
    assert params.registry.get("tpt_comp_alpha") == 42

    params.registry.set("tpt_comp_alpha", 9)
    assert params.registry.get("tpt_comp_alpha") == 9  # override > env
    monkeypatch.delenv(params.ENV_PREFIX + "tpt_comp_alpha")


def test_var_size_suffixes(pkg):
    reg = pkg.params.registry
    assert reg.register("tpt", "comp", "eager", "64k", int).value == 65536
    assert reg.register("tpt", "comp", "ring", "8m", int).value == 8 << 20


def test_var_bool_coercion(pkg, monkeypatch):
    monkeypatch.setenv(pkg.params.ENV_PREFIX + "tpt_comp_flag", "yes")
    var = pkg.params.registry.register("tpt", "comp", "flag", False, bool)
    assert var.value is True


def test_param_file(pkg, tmp_path, monkeypatch):
    params = pkg.params
    f = tmp_path / "params.conf"
    f.write_text("# comment\ntpt_comp_beta = 13\n")
    monkeypatch.setenv(params.PARAM_FILE_ENV, str(f))
    params.registry.refresh()
    var = params.registry.register("tpt", "comp", "beta", 1, int)
    assert var.value == 13
    assert var.source == params.SOURCE_FILE
    monkeypatch.delenv(params.PARAM_FILE_ENV)
    params.registry.refresh()


def test_pvar_counter(pkg):
    pv = pkg.params.registry.register_pvar("tpt", "comp", "msgs",
                                           var_class="counter")
    base = pv.read()
    pv.add(3)
    pv.add(2)
    assert pv.read() - base == 5


def _comp(pkg, name, priority, usable=True):
    class _Comp(pkg.base.Component):
        def query(self):
            if not self.usable:
                return None
            return (self.priority, f"module-{self.name}")

    c = _Comp()
    c.name, c.priority, c.usable = name, priority, usable
    return c


def test_framework_select_one_priority(pkg):
    fw = pkg.base.Framework("test", "tptfw1")
    fw.add_component(_comp(pkg, "lo", 10))
    fw.add_component(_comp(pkg, "hi", 50))
    fw.add_component(_comp(pkg, "broken", 99, usable=False))
    comp, payload = fw.select_one()
    assert comp.name == "hi"
    assert payload == "module-hi"


def test_framework_user_exclusion(pkg):
    fw = pkg.base.Framework("test", "tptfw2")
    fw.add_component(_comp(pkg, "a", 10))
    fw.add_component(_comp(pkg, "b", 50))
    reg = pkg.params.registry
    reg.register("tptfw2", "", "", "", str)
    reg.set("tptfw2", "^b")
    try:
        comp, _ = fw.select_one()
        assert comp.name == "a"
    finally:
        reg.set("tptfw2", "")


def test_framework_select_all_sorted(pkg):
    fw = pkg.base.Framework("test", "tptfw3")
    fw.add_component(_comp(pkg, "a", 10))
    fw.add_component(_comp(pkg, "b", 50))
    assert [c.name for _, c, _ in fw.select_all()] == ["b", "a"]


def test_parse_mca_args(pkg):
    params = pkg.params
    rest = params.parse_mca_args(
        ["prog", "--mca", "tpt_comp_gamma", "5", "arg1"])
    assert rest == ["prog", "arg1"]
    var = params.registry.register("tpt", "comp", "gamma", 0, int)
    assert var.value == 5


def test_schizo_accepts_ompi_mca_env(pkg, monkeypatch):
    """schizo/ompi analog: OMPI_MCA_* spellings resolve; the native
    TPUMPI_MCA_* prefix wins when both are set."""
    reg = pkg.params.registry
    reg.register("tpt", "schizo", "knob", 1, int)
    monkeypatch.setenv("OMPI_MCA_tpt_schizo_knob", "5")
    reg.refresh()
    assert reg.get("tpt_schizo_knob") == 5
    monkeypatch.setenv("TPUMPI_MCA_tpt_schizo_knob", "9")
    reg.refresh()
    assert reg.get("tpt_schizo_knob") == 9
    monkeypatch.delenv("OMPI_MCA_tpt_schizo_knob")
    monkeypatch.delenv("TPUMPI_MCA_tpt_schizo_knob")
    reg.refresh()
    assert reg.get("tpt_schizo_knob") == 1


def test_installdirs_fields_env_override_and_expand(pkg, monkeypatch):
    """installdirs analog (opal/mca/installdirs): package-derived
    defaults, TPUMPI_* env overrides, ${field} expansion; the same
    field names in both packages."""
    inst = pkg.installdirs
    dirs = inst.all_dirs()
    assert os.path.isdir(dirs["prefix"])
    assert os.path.isdir(dirs["libdir"])
    assert sorted(dirs) == sorted(_pkg("ref").installdirs.all_dirs())
    monkeypatch.setenv("TPUMPI_SYSCONFDIR", "/tmp/etc-override")
    assert inst.get("sysconfdir") == "/tmp/etc-override"
    assert inst.expand("${sysconfdir}/x.conf") == \
        "/tmp/etc-override/x.conf"
    with pytest.raises(KeyError):
        inst.get("no_such_dir")


def test_info_tool_reports_installdirs(pkg, capsys):
    assert pkg.info.main(["--parsable"]) == 0
    out = capsys.readouterr().out
    assert "installdirs:prefix:" in out


def test_installdirs_override_referencing_other_field(pkg, monkeypatch):
    inst = pkg.installdirs
    monkeypatch.setenv("TPUMPI_DATADIR", "${prefix}/share")
    got = inst.get("datadir")
    assert "${" not in got
    assert got == inst.get("prefix") + "/share"
