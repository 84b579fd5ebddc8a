"""`repro_torch.kernels.build.compile_sources` with a stand-in compiler:
each source's seconds are its own process's, and a failed build raises
while the others are kept. No nvcc is needed: the stand-in sleeps for
the seconds its source names and writes the output file."""
import sys
import textwrap

import pytest

from repro_torch.kernels import build

FAKE_NVCC = textwrap.dedent(f"""\
    #!{sys.executable}
    import sys, time
    args = sys.argv[1:]
    out, src = args[args.index("-o") + 1], args[-1]
    text = open(src).read().split()
    time.sleep(float(text[0]))
    print("ptxas info    : Used 8 registers")
    if text[1:] == ["fail"]:
        sys.exit(1)
    open(out, "w").write("built")
    """)


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    exe = tmp_path / "nvcc"
    exe.write_text(FAKE_NVCC)
    exe.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD", out)
    monkeypatch.setattr(build, "nvcc", lambda: str(exe))
    monkeypatch.setattr(build, "seconds", {})
    monkeypatch.setattr(build, "compiles", 0)

    def sources(**texts):
        for name, text in texts.items():
            (csrc / f"{name}.cu").write_text(text)
        return list(texts)
    return sources


def test_each_source_reads_its_own_seconds(fake_build):
    """The slow source is started first: the quick ones behind it must
    read their own seconds, not the slow one's."""
    names = fake_build(slow="2.0", quick="0.05", also_quick="0.05")
    targets = build.compile_sources(names)
    assert all(t.exists() for t in targets.values())
    assert build.compiles == 3
    assert build.seconds["slow"] >= 2.0
    assert build.seconds["quick"] < 1.0
    assert build.seconds["also_quick"] < 1.0
    assert "Used 8 registers" in build.build_log("quick")
    build.compile_sources(names)          # built already: nothing runs
    assert build.compiles == 3


def test_failed_source_raises_and_others_are_kept(fake_build):
    names = fake_build(good="0.05", bad="0.05 fail")
    with pytest.raises(RuntimeError, match="nvcc failed for bad.cu"):
        build.compile_sources(names)
    assert build._target("good").exists()
    assert not build._target("bad").exists()
    assert set(build.seconds) == {"good", "bad"}
