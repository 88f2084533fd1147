"""VcfAnnotateFromBed / VcfAnnotateFromVcf golden parity
(reference: src/tools-TEST/VcfAnnotateFrom*_Test.cpp). The config files use
paths relative to the reference build dir, so they are rewritten to absolute
paths in tmp."""

import pytest

from helpers import execute, compare_files


def test_vcf_annotate_from_bed(ref_data_in, ref_data_out, tmp_path):
    out = tmp_path / "o.vcf"
    assert execute("VcfAnnotateFromBed",
                   ["-in", ref_data_in / "VcfAnnotateFromBed_in1.vcf",
                    "-desc", "Custom_header_description!",
                    "-out", out, "-name", "OMIM",
                    "-bed", ref_data_in / "VcfAnnotateFromBed_in1.bed"]) == 0
    compare_files(out, ref_data_out / "VcfAnnotateFromBed_out1.vcf")


def _abs_config(ref_data_in, tmp_path, name):
    cfg = (ref_data_in / name).read_text()
    cfg = cfg.replace("../src/tools-TEST/data_in", str(ref_data_in))
    p = tmp_path / name
    p.write_text(cfg)
    return p


@pytest.mark.parametrize("args,golden", [
    (["-config_file", "CONFIG:VcfAnnotateFromVcf_config.tsv"], "VcfAnnotateFromVcf_out1.vcf"),
    (["-source", "VcfAnnotateFromVcf_an2_NGSD.vcf.gz", "-info_keys",
      "COUNTS,GSC01=GROUP,HAF,CLAS,CLAS_COM,COM", "-id_column", "ID",
      "-prefix", "NGSD"], "VcfAnnotateFromVcf_out2.vcf"),
    (["-source", "VcfAnnotateFromVcf_an2_NGSD.vcf.gz", "-info_keys",
      "GSC01=GROUP,CLAS,COM,CLAS_COM,COUNTS,HAF", "-id_column", "ID",
      "-prefix", "NGSD"], "VcfAnnotateFromVcf_out3.vcf"),
    (["-source", "VcfAnnotateFromVcf_an2_NGSD.vcf.gz", "-id_column", "ID",
      "-prefix", "NGSD"], "VcfAnnotateFromVcf_out4.vcf"),
    (["-config_file", "CONFIG:VcfAnnotateFromVcf_config2.tsv"], "VcfAnnotateFromVcf_out5.vcf"),
    (["-source", "VcfAnnotateFromVcf_an3_ExOnly.vcf.gz", "-existence_only"],
     "VcfAnnotateFromVcf_out6.vcf"),
])
def test_vcf_annotate_from_vcf(ref_data_in, ref_data_out, tmp_path, args, golden):
    out = tmp_path / "o.vcf"
    full = []
    it = iter(args)
    for a in it:
        full.append(a)
        if a == "-config_file":
            full.append(_abs_config(ref_data_in, tmp_path, next(it)[7:]))
        elif a == "-source":
            full.append(ref_data_in / next(it))
        elif a in ("-info_keys", "-id_column", "-prefix"):
            full.append(next(it))
    assert execute("VcfAnnotateFromVcf",
                   ["-in", ref_data_in / "VcfAnnotateFromVcf_in1.vcf",
                    "-out", out] + full) == 0
    compare_files(out, ref_data_out / golden)


def test_source_index_tabix_vs_inmemory(ref_data_in, tmp_path):
    """Both _SourceIndex paths (tabix random access when a .tbi exists vs
    the in-memory table) must annotate identically."""
    import shutil

    from helpers import execute

    src = ref_data_in / "VcfAnnotateFromVcf_an2_NGSD.vcf.gz"
    # indexed copy (tabix path) and unindexed copy (in-memory path)
    idx_src = tmp_path / "with_idx.vcf.gz"
    noidx_src = tmp_path / "no_idx.vcf.gz"
    shutil.copy(src, idx_src)
    shutil.copy(str(src) + ".tbi", str(idx_src) + ".tbi")
    shutil.copy(src, noidx_src)

    args = ["-in", ref_data_in / "VcfAnnotateFromVcf_in1.vcf",
            "-info_keys", "COUNTS,GSC01=GROUP,HAF,CLAS,CLAS_COM,COM",
            "-prefix", "NGSD"]
    out_a = tmp_path / "a.vcf"
    out_b = tmp_path / "b.vcf"
    assert execute("VcfAnnotateFromVcf",
                   args + ["-source", idx_src, "-out", out_a]) == 0
    assert execute("VcfAnnotateFromVcf",
                   args + ["-source", noidx_src, "-out", out_b]) == 0
    a = out_a.read_bytes()
    b = out_b.read_bytes()
    # the Description suffix embeds the source file name — normalize it
    a = a.replace(b"with_idx.vcf.gz", b"SRC")
    b = b.replace(b"no_idx.vcf.gz", b"SRC")
    assert a == b and len(a) > 0


def test_threads_identical_output(ref_data_in, tmp_path):
    """-threads N chunk workers produce byte-identical output to -threads 1
    (ordered chunk writes, like the reference's ChunkProcessor pool)."""
    from helpers import execute

    args = ["-in", ref_data_in / "VcfAnnotateFromVcf_in1.vcf",
            "-source", ref_data_in / "VcfAnnotateFromVcf_an2_NGSD.vcf.gz",
            "-info_keys", "COUNTS,GSC01=GROUP,HAF,CLAS,CLAS_COM,COM",
            "-prefix", "NGSD"]
    out1 = tmp_path / "t1.vcf"
    out4 = tmp_path / "t4.vcf"
    assert execute("VcfAnnotateFromVcf",
                   args + ["-out", out1, "-threads", "1"]) == 0
    assert execute("VcfAnnotateFromVcf",
                   args + ["-out", out4, "-threads", "4", "-block_size", "7"]) == 0
    assert out1.read_bytes() == out4.read_bytes()


def test_threads_fork_path_subprocess(ref_data_in, tmp_path):
    """The fork-based pool (taken when jax is unloaded — the CLI case) must
    match the sequential output; pytest holds jax, so exercise it through
    subprocesses."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = ["-in", str(ref_data_in / "VcfAnnotateFromVcf_in1.vcf"),
            "-source", str(ref_data_in / "VcfAnnotateFromVcf_an2_NGSD.vcf.gz"),
            "-info_keys", "COUNTS,HAF", "-prefix", "NGSD"]
    out1 = tmp_path / "f1.vcf"
    out2 = tmp_path / "f2.vcf"
    for out, extra in ((out1, ["-threads", "1"]),
                       (out2, ["-threads", "3", "-block_size", "5"])):
        r = subprocess.run(
            [sys.executable, "-m", "ngsbits_tpu", "VcfAnnotateFromVcf"]
            + base + ["-out", str(out)] + extra,
            env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-500:]
    assert out1.read_bytes() == out2.read_bytes() and out1.stat().st_size > 0
