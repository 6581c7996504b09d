"""The port's R shim (r/netrep_tpu_torch.R) against the port and against the
JAX package's shim. The port's file sources r/netrep_tpu.R and redefines
only its two Python handles and the three functions that gain `...`, so the
surface an R session sees is the JAX shim's with those definitions
replaced: every mapped name of that surface is a parameter of the port's
function with the default the R function gives it, the overrides keep the
JAX shim's arguments and defaults, and every Python handle reaches only the
port (``netrep_tpu_torch.api`` and ``netrep_tpu_torch.plot``). R runs on
neither machine, so both files are parsed, as tests/test_r_shim.py parses
the JAX shim; the helpers are copies of that file's."""

import importlib
import inspect
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R_FILE = os.path.join(ROOT, "r", "netrep_tpu_torch.R")
JAX_R_FILE = os.path.join(ROOT, "r", "netrep_tpu.R")


def _r_source(path=R_FILE):
    with open(path) as f:
        return f.read()


def _parse_r_list(body):
    out = {}
    for rname, pyname in re.findall(r"(\w+)\s*=\s*\"([\w.]+)\"", body):
        out[rname] = pyname
    assert out
    return out


def _mapping(name, path=JAX_R_FILE):
    """Parse `.name_args <- list(rName = "py_name", ...)` from a shim,
    following one alias (`.name_args <- .sharedVar`). The port's shim
    defines no list of its own, so the default is the JAX shim's."""
    src = _r_source(path)
    alias = re.search(rf"\.{name}_args\s*<-\s*(\.\w+)\s*\n", src)
    if alias:
        shared = re.escape(alias.group(1))
        m = re.search(rf"{shared}\s*<-\s*list\((.*?)\)\s*\n", src,
                      flags=re.S)
        assert m, f"shared map {alias.group(1)} not found in {path}"
        return _parse_r_list(m.group(1))
    m = re.search(rf"\.{name}_args\s*<-\s*list\((.*?)\)\s*\n", src,
                  flags=re.S)
    assert m, f".{name}_args list not found in {path}"
    return _parse_r_list(m.group(1))


def _r_defaults(fn_name, path=None):
    """The R function's arguments in order, each with its default (None
    where it has none); `...` is left out. Without ``path``, the
    definition an R session that sourced the port's shim sees."""
    path = path or _defining_file(fn_name)
    m = re.search(rf"^{fn_name}\s*<-\s*function\((.*?)\)\s*\{{",
                  _r_source(path), flags=re.S | re.M)
    assert m, f"{fn_name} not found in {path}"
    args = {}
    for part in re.split(r",(?![^()]*\))", m.group(1)):
        part = part.strip()
        if not part or part == "...":
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            args[k.strip()] = v.strip()
        else:
            args[part] = None
    return args


_R_TO_PY = {"NULL": None, "TRUE": True, "FALSE": False}


def _as_py(r_default):
    if r_default is None:
        return inspect.Parameter.empty
    if r_default in _R_TO_PY:
        return _R_TO_PY[r_default]
    if r_default.startswith('"'):
        return r_default.strip('"')
    if re.fullmatch(r"\d+L?", r_default):
        return int(r_default.rstrip("L"))
    if re.fullmatch(r"[\d.]+", r_default):
        return float(r_default)
    pytest.fail(f"unparsed R default: {r_default}")


CASES = [
    ("modulePreservation", "netrep_tpu_torch.api", "module_preservation"),
    ("networkProperties", "netrep_tpu_torch.api", "network_properties"),
    ("requiredPerms", "netrep_tpu_torch.api", "required_perms"),
    ("plotModule", "netrep_tpu_torch.plot", "plot_module"),
    ("plotData", "netrep_tpu_torch.plot", "plot_data"),
    ("plotCorrelation", "netrep_tpu_torch.plot", "plot_correlation"),
    ("plotNetwork", "netrep_tpu_torch.plot", "plot_network"),
    ("plotContribution", "netrep_tpu_torch.plot", "plot_contribution"),
    ("plotDegree", "netrep_tpu_torch.plot", "plot_degree"),
    ("nodeOrder", "netrep_tpu_torch.plot", "node_order"),
    ("sampleOrder", "netrep_tpu_torch.plot", "sample_order"),
]


def _functions(path):
    return re.findall(r"^([\w.]+)\s*<-\s*function\(", _r_source(path),
                      flags=re.M)


#: what the port's shim redefines after sourcing the JAX shim
HANDLES = [".netrep", ".callPlot"]
OVERRIDES = ["networkProperties", "nodeOrder", "sampleOrder"]


def _definitions(path):
    """Top-level assignments of a shim, in order: (name, code up to the
    next top-level assignment, comment lines left out)."""
    src = re.sub(r"^\s*#.*\n", "", _r_source(path), flags=re.M)
    heads = list(re.finditer(r"^([\w.]+)\s*<-", src, flags=re.M))
    return [(m.group(1), src[m.start():nxt.start() if nxt else len(src)])
            for m, nxt in zip(heads, heads[1:] + [None])]


def _defining_file(fn_name):
    return R_FILE if fn_name in _functions(R_FILE) else JAX_R_FILE


def _body(fn_name):
    """The text of the definition an R session that sourced the port's
    shim calls."""
    return dict(_definitions(_defining_file(fn_name)))[fn_name]


@pytest.mark.parametrize("r_name,module,py_name", CASES)
def test_mapped_args_exist_with_matching_defaults(r_name, module, py_name):
    py_fn = getattr(importlib.import_module(module), py_name)
    assert py_fn.__module__.startswith("netrep_tpu_torch.")
    sig = inspect.signature(py_fn)
    mapping = _mapping(r_name)
    r_defaults = _r_defaults(r_name)
    assert set(r_defaults) == set(mapping), (r_name, sorted(r_defaults),
                                             sorted(mapping))
    for rname, pyname in mapping.items():
        assert pyname in sig.parameters, (
            f"{r_name}.{rname} maps to {py_name}.{pyname}, which does not "
            "exist in the port")
        want = _as_py(r_defaults[rname])
        got = sig.parameters[pyname].default
        assert got == want, (f"{r_name}.{rname} default {want!r} != "
                             f"{py_name}.{pyname} default {got!r}")


@pytest.mark.parametrize("r_name", OVERRIDES)
def test_overrides_keep_the_jax_shim_arguments(r_name):
    """An override takes the JAX shim's arguments, in order, with its
    defaults, forwards each under its mapped Python name, and adds `...`."""
    assert _r_defaults(r_name, R_FILE) == _r_defaults(r_name, JAX_R_FILE)
    assert list(_r_defaults(r_name, R_FILE)) == list(
        _r_defaults(r_name, JAX_R_FILE))
    body = _body(r_name)
    for rname, pyname in _mapping(r_name).items():
        assert re.search(rf"\b{pyname}\s*=\s*{rname}\b", body), (
            r_name, rname)
    assert "..." not in dict(_definitions(JAX_R_FILE))[r_name]


def test_sources_the_jax_shim_and_redefines_only_the_handles():
    """The port's file sources r/netrep_tpu.R into its own environment
    before any of its definitions, defines no mapping list, and redefines
    only the two handles and the three functions; the surface is the JAX
    shim's 13 functions."""
    src = _r_source()
    source = re.search(r'^source\(file\.path\([\w.]+, "netrep_tpu\.R"\), '
                       r"local = environment\(\)\)", src, flags=re.M)
    assert source
    names = [n for n, _ in _definitions(R_FILE)]
    assert names == [".netrep_tpu_torch_dir"] + HANDLES + OVERRIDES
    assert src.index(".netrep <- local") > source.end()
    assert not re.search(r"_args\s*<-", src)
    jax_names = [n for n, _ in _definitions(JAX_R_FILE)]
    assert set(HANDLES + OVERRIDES) <= set(jax_names)
    assert len(_functions(JAX_R_FILE)) == 13
    public = [f for f in _functions(JAX_R_FILE) if not f.startswith(".")]
    for fn in ("modulePreservation", "networkProperties", "requiredPerms",
               "nodeOrder", "sampleOrder", "combineAnalyses", "plotModule",
               "plotData", "plotCorrelation", "plotNetwork",
               "plotContribution", "plotDegree"):
        assert fn in public, fn


def test_call_plot_is_the_jax_glue_on_the_port():
    ours = dict(_definitions(R_FILE))[".callPlot"]
    theirs = dict(_definitions(JAX_R_FILE))[".callPlot"]
    body = re.search(r"^\.callPlot <- function.*?^}", theirs,
                     flags=re.S | re.M).group(0)
    assert body.replace('"netrep_tpu.plot"', '"netrep_tpu_torch.plot"') in ours


def test_forwards_only_to_the_port():
    """The port's file imports only the port, and every import of the JAX
    shim sits in a handle the port's file redefines; every call through
    `.netrep()` names a function of the port's surface."""
    src = _r_source()
    imports = re.findall(r"reticulate::import\(\"([\w.]+)\"\)", src)
    assert set(imports) == {"netrep_tpu_torch.api", "netrep_tpu_torch.plot"}
    # the JAX shim's file name is the one mention of the JAX package
    assert not re.search(r"[\"']netrep_tpu[\"'.]",
                         src.replace('"netrep_tpu.R"', ""))
    for name, text in _definitions(JAX_R_FILE):
        if "reticulate::import" in text:
            assert name in HANDLES, name
    api = importlib.import_module("netrep_tpu_torch.api")
    calls = []
    for name in _functions(JAX_R_FILE):
        calls += re.findall(r"\.netrep\(\)\$(\w+)", _body(name))
    assert calls == ["module_preservation", "network_properties",
                     "required_perms", "combine_analyses"]
    for py_name in calls:
        assert getattr(api, py_name).__module__.startswith(
            "netrep_tpu_torch."), py_name


def test_device_rides_through_the_extras():
    """The port's extras reach Python under their own names: every
    function that reaches a device passes `...` on."""
    for fn in ("modulePreservation", "networkProperties", "nodeOrder",
               "sampleOrder", "combineAnalyses", "plotModule", "plotData",
               "plotCorrelation", "plotNetwork", "plotContribution",
               "plotDegree"):
        head = re.search(rf"^{fn}\s*<-\s*function\((.*?)\n}}", _body(fn),
                         flags=re.S | re.M).group(1)
        assert head.count("...") >= 2, fn
    assert "..." not in _body("requiredPerms")
    params = inspect.signature(importlib.import_module(
        "netrep_tpu_torch.api").module_preservation).parameters
    head = _r_source().split(".netrep_tpu_torch_dir <- local")[0]
    for extra in ("device", "seed", "config", "mesh", "profile",
                  "checkpoint_dir", "backend"):
        assert extra in params and extra in head, extra


def test_combine_analyses_shim_override():
    from netrep_tpu_torch.api import combine_analyses

    assert _mapping("combineAnalyses") == {
        "allowDuplicateNulls": "allow_duplicate_nulls"}
    assert list(_r_defaults("combineAnalyses")) == [
        "analysis1", "analysis2", "allowDuplicateNulls"]
    p = inspect.signature(combine_analyses).parameters[
        "allow_duplicate_nulls"]
    assert p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is False


def test_header_says_it_is_a_parsed_stub():
    head = _r_source().split(".netrep_tpu_torch_dir <- local")[0]
    assert "R is not installed" in head
    assert "tests/test_torch_r_shim.py" in head
    assert 'source("r/netrep_tpu_torch.R")' in head
