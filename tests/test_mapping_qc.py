"""MappingQC golden parity vs reference tools-TEST (MappingQC_Test.cpp).

No reference genome FASTA ships in this environment (the reference's own CI
skips these tests without one — SKIP_IF_NO_HG19_GENOME). A stub FASTA with
the real .fai is used instead, and the genome-derived lines (AT/GC dropout;
genome-size-normalized depths in wgs/rna modes) are stripped from the
comparison. Everything else is exact. panel.bam-based tests (01/06) are
omitted: that fixture is absent from the mount.
"""

import shutil

import pytest

from helpers import QCML_STRIP, compare_files, execute

GENOME_STRIP = (r"AT dropout", r"GC dropout")
WGS_GENOME_STRIP = GENOME_STRIP + (r"QC:2000025", r"QC:2000150",
                                   r"target region read depth")


@pytest.fixture(scope="module")
def stub_ref(tmp_path_factory, request):
    d = tmp_path_factory.mktemp("ref")
    ref = d / "hg19.fa"
    ref.write_bytes(b"")
    shutil.copy("/root/reference/src/tools-TEST/data_in/hg19.fa.fai",
                str(ref) + ".fai")
    return str(ref)


def test_txt_mode(ref_data_in, ref_data_out, tmp_path, stub_ref):
    out = tmp_path / "m2.txt"
    assert execute("MappingQC", ["-in", ref_data_in / "MappingQC_in2.bam",
                                 "-roi", ref_data_in / "MappingQC_in2.bed",
                                 "-build", "hg19", "-out", out, "-txt",
                                 "-ref", stub_ref]) == 0
    compare_files(out, ref_data_out / "MappingQC_test02_out.txt", GENOME_STRIP)


def test_roi_qcml(ref_data_in, ref_data_out, tmp_path, stub_ref):
    out = tmp_path / "m3.qcML"
    assert execute("MappingQC", ["-in", ref_data_in / "MappingQC_in1.bam",
                                 "-roi", ref_data_in / "MappingQC_in2.bed",
                                 "-build", "hg19", "-out", out,
                                 "-ref", stub_ref]) == 0
    compare_files(out, ref_data_out / "MappingQC_test03_out.qcML",
                  QCML_STRIP + GENOME_STRIP)


def test_wgs(ref_data_in, ref_data_out, tmp_path, stub_ref):
    out = tmp_path / "m4.qcML"
    assert execute("MappingQC", ["-in", ref_data_in / "MappingQC_in2.bam",
                                 "-wgs", "-build", "hg19", "-out", out,
                                 "-ref", stub_ref]) == 0
    compare_files(out, ref_data_out / "MappingQC_test04_out.qcML",
                  QCML_STRIP + WGS_GENOME_STRIP)


def test_wgs_in1(ref_data_in, ref_data_out, tmp_path, stub_ref):
    out = tmp_path / "m5.qcML"
    assert execute("MappingQC", ["-in", ref_data_in / "MappingQC_in1.bam",
                                 "-wgs", "-build", "hg19", "-out", out,
                                 "-ref", stub_ref]) == 0
    compare_files(out, ref_data_out / "MappingQC_test05_out.qcML",
                  QCML_STRIP + WGS_GENOME_STRIP)


def test_rna(ref_data_in, ref_data_out, tmp_path, stub_ref):
    out = tmp_path / "m7.qcML"
    assert execute("MappingQC", ["-in", ref_data_in / "MappingQC_in3.bam",
                                 "-rna", "-build", "hg19", "-out", out,
                                 "-ref", stub_ref]) == 0
    compare_files(out, ref_data_out / "MappingQC_test07_out.qcML",
                  QCML_STRIP + WGS_GENOME_STRIP)


def test_cfdna(ref_data_in, ref_data_out, tmp_path, stub_ref):
    out = tmp_path / "m8.qcML"
    assert execute("MappingQC", ["-in", ref_data_in / "MappingQC_in4.bam",
                                 "-roi", ref_data_in / "MappingQC_in3.bed",
                                 "-cfdna", "-build", "hg19", "-out", out,
                                 "-ref", stub_ref]) == 0
    compare_files(out, ref_data_out / "MappingQC_test08_out.qcML",
                  QCML_STRIP + GENOME_STRIP)


def test_somatic_custom(ref_data_in, ref_data_out, tmp_path, stub_ref):
    out = tmp_path / "m9.qcML"
    assert execute("MappingQC", ["-in", ref_data_in / "MappingQC_in2.bam",
                                 "-somatic_custom_bed", ref_data_in / "MappingQC_in2_custom_subpanel.bed",
                                 "-roi", ref_data_in / "MappingQC_in2.bed",
                                 "-build", "hg19", "-out", out,
                                 "-ref", stub_ref]) == 0
    compare_files(out, ref_data_out / "MappingQC_test09_out.qcML",
                  QCML_STRIP + GENOME_STRIP)


@pytest.fixture(scope="module")
def stub_ref38(tmp_path_factory):
    import subprocess
    d = tmp_path_factory.mktemp("ref38")
    ref = d / "hg38.fa"
    ref.write_bytes(b"")
    # synthesize an hg38 .fai from any hg38 BAM header
    from ngsbits_tpu.io.bam import BamReader
    r = BamReader("/root/reference/src/tools-TEST/data_in/MappingQC_in5.bam")
    with open(str(ref) + ".fai", "w") as fh:
        for n, l in zip(r.ref_names, r.ref_lengths):
            fh.write(f"{n}\t{l}\t0\t60\t61\n")
    r.close()
    return str(ref)


def test_wgs_hg38_with_read_qc(ref_data_in, ref_data_out, tmp_path, stub_ref38):
    out = tmp_path / "m10.qcML"
    rqc = tmp_path / "m11.qcML"
    assert execute("MappingQC", ["-in", ref_data_in / "MappingQC_in5.bam",
                                 "-wgs", "-build", "hg38", "-out", out,
                                 "-read_qc", rqc, "-ref", stub_ref38]) == 0
    compare_files(out, ref_data_out / "MappingQC_test10_out.qcML",
                  QCML_STRIP + WGS_GENOME_STRIP)
    compare_files(rqc, ref_data_out / "MappingQC_test11_out.qcML", QCML_STRIP)


def test_single_end_with_read_qc(ref_data_in, ref_data_out, tmp_path, stub_ref38):
    if not (ref_data_in / "MappingQC_in6.bam").exists():
        pytest.skip("MappingQC_in6.bam not present in this reference mount")
    out = tmp_path / "m12.qcML"
    rqc = tmp_path / "m13.qcML"
    assert execute("MappingQC", ["-single_end", "-in", ref_data_in / "MappingQC_in6.bam",
                                 "-wgs", "-build", "hg38", "-out", out,
                                 "-read_qc", rqc, "-ref", stub_ref38]) == 0
    compare_files(out, ref_data_out / "MappingQC_test12_out.qcML",
                  QCML_STRIP + WGS_GENOME_STRIP)
    compare_files(rqc, ref_data_out / "MappingQC_test13_out.qcML", QCML_STRIP)
