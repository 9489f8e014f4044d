"""Every CUDA source of the port is built, and every kernel built has a
source: ``kernels/build.py::SOURCES`` lists exactly the ``csrc/*.cu``
files, so ``chip_smoke.py`` (which builds ``SOURCES``) cannot leave a
kernel unbuilt; and an edit to a source or to a shared header gives a new
library name, so a stale build is never loaded.  Nothing here needs
``nvcc``."""
import shutil

from repro_torch.kernels import build


def test_sources_list_every_cuda_file_and_nothing_else():
    on_disk = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sorted(build.SOURCES) == on_disk
    assert len(set(build.SOURCES)) == len(build.SOURCES)


def test_library_name_follows_sources_and_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(before.values())) == len(build.SOURCES)
    assert all(p.parent == build.BUILD_DIR for p in before.values())
    (csrc / "cbp_matmul.cu").write_text(
        (csrc / "cbp_matmul.cu").read_text() + "\n")
    assert build.library_path("cbp_matmul") != before["cbp_matmul"]
    assert build.library_path("ssd_scan") == before["ssd_scan"]
    header = sorted(csrc.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n")
    assert build.library_path("ssd_scan") != before["ssd_scan"]
