"""Execute docs/vignette_torch.md, the port's walkthrough: every ```python
block runs verbatim, in order, in one shared namespace with ``DEVICE =
"cpu"`` (the document tells the reader to set it; no block chooses a
device), as tests/test_vignette.py runs the JAX package's walkthrough. A
drifting document fails the suite."""

import os
import re

import pytest

VIGNETTE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "docs", "vignette_torch.md",
)


def _blocks():
    with open(VIGNETTE) as f:
        return re.findall(r"```python\n(.*?)```", f.read(), flags=re.S)


@pytest.fixture(autouse=True)
def stores(tmp_path_factory, monkeypatch):
    """The walkthrough's runs record into an autotune store of their own,
    and its native block builds into a kernel-library store of its own."""
    monkeypatch.setenv("NETREP_AUTOTUNE_STORE",
                       str(tmp_path_factory.mktemp("autotune")))
    monkeypatch.setenv("NETREP_AOT_STORE",
                       str(tmp_path_factory.mktemp("aot")))


def test_vignette_follows_the_jax_walkthrough():
    with open(VIGNETTE) as f:
        text = f.read()
    with open(os.path.join(os.path.dirname(VIGNETTE), "vignette.md")) as f:
        jax_sections = re.findall(r"^## (\d+)\. ", f.read(), flags=re.M)
    assert re.findall(r"^## (\d+)\. ", text, flags=re.M)[:len(
        jax_sections)] == jax_sections
    blocks = _blocks()
    assert len(blocks) >= 20
    for block in blocks:
        assert "import netrep_tpu\n" not in block and "jax" not in block
        assert "cuda.is_available" not in block and "DEVICE =" not in block
        for call in re.findall(r"nt\.(?:module_preservation|network_"
                               r"properties|properties_table|plot_\w+|"
                               r"sparse_\w+|selftest)\((.*?)\n\)", block,
                               flags=re.S):
            assert "device=" in call, call
    assert 'DEVICE = "cuda"' in text


def test_vignette_blocks_execute(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # artifacts (png, checkpoints) land in tmp
    import matplotlib

    matplotlib.use("Agg")
    ns: dict = {"DEVICE": "cpu"}
    for i, block in enumerate(_blocks()):
        try:
            exec(compile(block, f"vignette_torch block {i + 1}", "exec"), ns)
        except Exception as e:  # pragma: no cover - failure reporting
            pytest.fail(
                f"vignette_torch block {i + 1} failed ({type(e).__name__}: "
                f"{e}):\n{block}")
    assert (tmp_path / "module_preservation.png").exists()
    assert (tmp_path / "sparse_module.png").exists()
    assert ns["result"].completed == 250
    assert ns["r2"].completed == 256
    assert ns["both"].completed == 256
    assert ns["report"]["ok"]
