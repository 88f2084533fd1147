"""Library-test corpus lane — cppNGS-TEST replayed at the API level.

The tools-TEST corpus replay (test_ref_parity.py) covers the CLI layer; this
file replays the reference's LIBRARY test assertions directly against the
Python API, starting with ``cppNGS-TEST/Statistics_Test.cpp``.  Each test
method below mirrors one reference TEST_METHOD with the same pinned values
(S_EQUAL/I_EQUAL/F_EQUAL2 -> assert); genome-FASTA-gated methods
(SKIP_IF_NO_HG38_GENOME) are omitted because no genome exists in this mount.
"""

from __future__ import annotations

import numpy as np
import pytest

NGS_TEST = "/root/reference/src/cppNGS-TEST"
DIN = f"{NGS_TEST}/data_in"
TOOLS_DIN = "/root/reference/src/tools-TEST/data_in"


def _check_descriptions(stats):
    for v in stats:
        assert v.description != ""
        assert v.accession != ""


# ---- Statistics_Test.cpp ---------------------------------------------------

PANEL_BAM = f"{DIN}/panel.bam"  # stripped large blob (.MISSING_LARGE_BLOBS)


def _require(path: str):
    import os
    if not os.path.exists(path):
        pytest.skip(f"fixture {os.path.basename(path)} is a stripped large blob "
                    "in this mount (/root/reference/.MISSING_LARGE_BLOBS)")



def test_statistics_somatic():
    """Statistics_Test.cpp:12-52 (somatic)."""
    from ngsbits_tpu.core.intervals import BedFile
    from ngsbits_tpu.qc.somatic import somatic

    target = BedFile.from_file(f"{DIN}/Statistics_somatic_tmb_target.bed")
    stats = somatic("hg19", f"{DIN}/tumor.bam", f"{DIN}/normal.bam",
                    f"{DIN}/Statistics_somatic_tmb.vcf", "", target, True)
    vals = list(stats)
    assert (vals[0].name, vals[0].accession) == ("sample correlation", "QC:2000040")
    assert vals[0].to_string() == "n/a (too few variants)"
    assert (vals[1].name, vals[1].accession) == ("variant count", "QC:2000013")
    assert vals[1].to_string() == "77"
    assert (vals[2].name, vals[2].accession) == ("somatic variant count", "QC:2000041")
    assert vals[2].to_string() == "64"
    assert (vals[3].name, vals[3].accession) == ("known somatic variants percentage",
                                                 "QC:2000045")
    assert vals[3].to_string() == "n/a (no gnomADg_AF annotation info field)"
    assert (vals[4].name, vals[4].accession) == ("somatic indel variants percentage",
                                                 "QC:2000042")
    assert vals[4].to_string() == "0.00"
    assert (vals[5].name, vals[5].accession) == ("somatic transition/transversion ratio",
                                                 "QC:2000043")
    assert vals[5].to_string() == "6.11"
    assert vals[6].accession == "QC:2000054"
    assert vals[6].to_string() == "n/a (too few variants)"
    assert len(vals) == 7
    _check_descriptions(stats)


def test_statistics_somatic_mutation_burden():
    """Statistics_Test.cpp:54-93 (somatic_mutation_burden)."""
    from ngsbits_tpu.qc.somatic import mutation_burden, mutation_burden_normalized

    somatic_vcf = f"{TOOLS_DIN}/SomaticQC_in7.vcf"
    exons = f"{TOOLS_DIN}/SomaticQC_tmb_exons.bed"
    target = f"{TOOLS_DIN}/SomaticQC_in8.bed"
    tsg = f"{TOOLS_DIN}/SomaticQC_tmb_tsg.bed"
    blacklist = f"{TOOLS_DIN}/SomaticQC_tmb_blacklist.bed"

    tmb = mutation_burden(somatic_vcf, target, blacklist)
    assert (tmb.name, tmb.accession) == ("raw somatic variant rate", "QC:2000089")
    assert tmb.to_string() == "0.12"

    tmb = mutation_burden_normalized(somatic_vcf, exons, target, tsg, blacklist)
    assert (tmb.name, tmb.accession) == ("somatic variant rate", "QC:2000053")
    assert tmb.to_string() == "4.41"

    tsg = f"{DIN}/Statistics_somatic_tmb_tsg.bed"
    tmb = mutation_burden_normalized(somatic_vcf, exons, target, tsg, blacklist)
    assert tmb.to_string() == "2.23"

    blacklist = f"{DIN}/Statistics_somatic_tmb_blacklist.bed"  # empty file
    tmb = mutation_burden_normalized(somatic_vcf, exons, target, tsg, blacklist)
    assert tmb.to_string() == "n/a"


def test_statistics_variant_list_panel_filter():
    """Statistics_Test.cpp:95-115 (variantList_panel_filter)."""
    from ngsbits_tpu.io.vcf import VcfFile
    from ngsbits_tpu.qc.variant_stats import variant_list

    vl = VcfFile.from_file(f"{DIN}/panel_vep.vcf")
    stats = variant_list(vl, True)
    vals = list(stats)
    assert (vals[0].name, vals[0].accession) == ("variant count", "QC:2000013")
    assert vals[0].to_string() == "152"
    assert (vals[1].name, vals[1].accession) == ("known variants percentage", "QC:2000014")
    assert vals[1].to_string() == "100.00"
    assert len(vals) == 7
    _check_descriptions(stats)


def test_statistics_variant_list_panel_nofilter():
    """Statistics_Test.cpp:117-148 (variantList_panel_nofilter)."""
    from ngsbits_tpu.io.vcf import VcfFile
    from ngsbits_tpu.qc.variant_stats import variant_list

    vl = VcfFile.from_file(f"{DIN}/panel_vep.vcf")
    stats = variant_list(vl, False)
    vals = list(stats)
    assert vals[0].to_string() == "326"
    assert vals[1].to_string() == "99.69"
    assert (vals[2].name, vals[2].accession) == ("high-impact variants percentage",
                                                 "QC:2000015")
    assert vals[2].to_string() == "0.61"
    assert vals[3].name == "homozygous variants percentage"
    assert vals[3].to_string() == "34.05"
    assert vals[4].name == "indel variants percentage"
    assert vals[4].to_string() == "13.80"
    assert vals[5].name == "transition/transversion ratio"
    assert vals[5].to_string() == "2.16"
    assert vals[6].name == "mosaic variant count"
    assert vals[6].to_string() == "0"
    assert len(vals) == 7
    _check_descriptions(stats)


def test_statistics_variant_list_empty():
    """Statistics_Test.cpp:150-177 (variantList_empty)."""
    from ngsbits_tpu.io.vcf import VcfFile
    from ngsbits_tpu.qc.variant_stats import variant_list

    stats = variant_list(VcfFile(), True)
    vals = list(stats)
    assert vals[0].name == "variant count"
    assert vals[0].to_string() == "0"
    for i, name in ((1, "known variants percentage"), (2, "high-impact variants percentage"),
                    (3, "homozygous variants percentage"), (4, "indel variants percentage"),
                    (5, "transition/transversion ratio")):
        assert vals[i].name == name
        assert vals[i].to_string().startswith("n/a ")
    assert vals[6].name == "mosaic variant count"
    assert vals[6].to_string() == "0"
    assert len(vals) == 7
    _check_descriptions(stats)


def test_statistics_contamination():
    """Statistics_Test.cpp:285-299 (contamination)."""
    from ngsbits_tpu.qc.mapping_stats import contamination

    _require(PANEL_BAM)
    stats = contamination("hg38", f"{DIN}/panel.bam")
    vals = list(stats)
    assert len(vals) == 1
    assert vals[0].name == "SNV allele frequency deviation"
    assert vals[0].to_string() == "4.76"

    stats = contamination("hg38", f"{DIN}/panel.bam", roi_file=f"{DIN}/panel.bed")
    vals = list(stats)
    assert len(vals) == 1
    assert vals[0].to_string() == "5.77"


@pytest.mark.parametrize("merge,bases,fragments,sorted_,merged,fmax,fmean,fstdev", [
    (True, "92168", "590", "yes", "yes", "1000", "156.22", "106.31"),   # region1 (:568)
    (False, "92369", "592", "no", "no", "965", "156.03", "102.36"),     # region2 (:600)
])
def test_statistics_region_demo(merge, bases, fragments, sorted_, merged, fmax,
                                fmean, fstdev):
    """Statistics_Test.cpp:568-632 (region1/region2)."""
    from ngsbits_tpu.core.intervals import BedFile
    from ngsbits_tpu.qc.statistics import region

    bed = BedFile.from_file(f"{DIN}/demo_unmerged.bed")
    stats = region(bed, merge)
    vals = list(stats)
    assert vals[0].name == "roi_bases"
    assert vals[0].to_string(0) == bases
    assert vals[1].name == "roi_fragments"
    assert vals[1].to_string() == fragments
    assert vals[2].name == "roi_chromosomes"
    assert vals[2].to_string() == "13 (1, 2, 3, 4, 6, 7, 8, 10, 12, 16, 17, 18, 22)"
    assert vals[3].name == "roi_is_sorted"
    assert vals[3].to_string() == sorted_
    assert vals[4].name == "roi_is_merged"
    assert vals[4].to_string() == merged
    assert vals[5].name == "roi_fragment_min"
    assert vals[5].to_string() == "21"
    assert vals[6].name == "roi_fragment_max"
    assert vals[6].to_string() == fmax
    assert vals[7].name == "roi_fragment_mean"
    assert vals[7].to_string() == fmean
    assert vals[8].name == "roi_fragment_stdev"
    assert vals[8].to_string() == fstdev
    assert len(vals) == 9
    for v in vals:
        assert v.description != ""


def test_statistics_region3_wgs():
    """Statistics_Test.cpp:633-663 (region3)."""
    from ngsbits_tpu.core.intervals import BedFile
    from ngsbits_tpu.qc.statistics import region

    bed = BedFile.from_file(f"{DIN}/WGS_hg19.bed")
    stats = region(bed, False)
    vals = list(stats)
    assert vals[1].to_string() == "25"
    assert vals[0].to_string(0) == "3095693958"
    assert vals[3].to_string() == "yes"
    assert vals[4].to_string() == "yes"
    assert vals[5].to_string() == "16570"
    assert vals[6].to_string() == "249250620"
    assert vals[7].to_string(2) == "123827758.32"
    assert vals[8].to_string(2) == "61027437.29"
    assert len(vals) == 9


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
def test_statistics_low_coverage_roi_mapq20(threads):
    """Statistics_Test.cpp:664-689 (lowCoverage_roi_mapq20 + _multiple_threads)."""
    _require(PANEL_BAM)
    from ngsbits_tpu.core.intervals import BedFile
    from ngsbits_tpu.qc.coverage import low_or_high_coverage

    bed = BedFile.from_file(f"{DIN}/panel.bed")
    bed.merge()
    assert bed.base_count() == 271536
    low = low_or_high_coverage(bed, f"{DIN}/panel.bam", 20, 20, 0, threads, False)
    assert len(low.lines) == 450
    assert low.base_count() == 16129


def test_statistics_low_coverage_close_exons_and_bug_cases():
    """Statistics_Test.cpp:691-712 (lowCoverage closeExons/bug_case1/bug_case2)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine
    from ngsbits_tpu.qc.coverage import low_or_high_coverage

    bed = BedFile.from_file(f"{DIN}/close_exons.bed")
    bed.merge()
    assert bed.base_count() == 154
    low = low_or_high_coverage(bed, f"{DIN}/close_exons.bam", 20, 1, 0, 1, False)
    assert low.base_count() == 0

    for case in ("lowcov_bug_case1", "lowcov_bug_case2"):
        roi = BedFile()
        roi.append(BedLine(Chromosome("chr13"), 32931869, 32931970))
        low = low_or_high_coverage(roi, f"{DIN}/{case}.bam", 20, 1, 0, 1, False)
        assert low.base_count() == 0


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
def test_statistics_high_coverage_roi_mapq20(threads):
    """Statistics_Test.cpp:714-739 (highCoverage_roi_mapq20 + _multiple_threads)."""
    _require(PANEL_BAM)
    from ngsbits_tpu.core.intervals import BedFile
    from ngsbits_tpu.qc.coverage import low_or_high_coverage

    bed = BedFile.from_file(f"{DIN}/panel.bed")
    bed.merge()
    assert bed.base_count() == 271536
    high = low_or_high_coverage(bed, f"{DIN}/panel.bam", 20, 20, 0, threads, True)
    assert len(high.lines) == 1707
    assert high.base_count() == 255407


def test_statistics_avg_coverage_overlapping_regions():
    """Statistics_Test.cpp:741-757 (avgCoverage_overlapping_regions)."""
    _require(PANEL_BAM)
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine
    from ngsbits_tpu.qc.coverage import avg_coverage

    bed = BedFile()
    bed.append(BedLine(Chromosome("chr1"), 11013718, 11013975))
    bed.append(BedLine(Chromosome("chr1"), 11013718, 11013818))
    bed.append(BedLine(Chromosome("chr1"), 11013818, 11013975))
    avg_coverage(bed, f"{DIN}/panel.bam", 20, 1, 2)
    assert len(bed.lines) == 3
    assert bed.lines[0].chr == Chromosome("chr1")
    assert (bed.lines[0].start, bed.lines[0].end) == (11013718, 11013975)
    assert bed.lines[0].annotations[0] == b"106.40"
    assert bed.lines[1].annotations[0] == b"75.07"
    assert bed.lines[2].annotations[0] == b"126.03"


def test_statistics_avg_coverage_1decimal():
    """Statistics_Test.cpp:759-776 (avgCoverage_1decimal)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile
    from ngsbits_tpu.qc.coverage import avg_coverage

    bed = BedFile.from_file(f"{DIN}/close_exons.bed")
    bed.merge()
    avg_coverage(bed, f"{DIN}/close_exons.bam", 20, 1, 1)
    assert len(bed.lines) == 2
    assert bed.lines[0].chr == Chromosome("chr1")
    assert (bed.lines[0].start, bed.lines[0].end) == (45332753, 45332844)
    assert bed.lines[0].annotations[0] == b"454.0"
    assert (bed.lines[1].start, bed.lines[1].end) == (45332908, 45332969)
    assert bed.lines[1].annotations[0] == b"292.1"


@pytest.mark.parametrize("threads", [2, 4, 8])
def test_statistics_avg_coverage_multiple_threads(threads):
    """Statistics_Test.cpp:778-797 (avgCoverage_multiple_threads)."""
    _require(PANEL_BAM)
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile
    from ngsbits_tpu.qc.coverage import avg_coverage

    bed = BedFile.from_file(f"{DIN}/panel.bed")
    avg_coverage(bed, f"{DIN}/panel.bam", 20, threads, 2)
    assert len(bed.lines) == 1532
    assert bed.lines[0].chr == Chromosome("chr1")
    assert (bed.lines[0].start, bed.lines[0].end) == (11013718, 11013975)
    assert bed.lines[0].annotations[1] == b"106.40"
    assert (bed.lines[1].start, bed.lines[1].end) == (11016834, 11017017)
    assert bed.lines[1].annotations[1] == b"146.57"


def test_statistics_gender_xy():
    """Statistics_Test.cpp:799-822 (genderXY incl. long-read)."""
    from ngsbits_tpu.tools.sample_gender import gender_xy

    import os
    if os.path.exists(PANEL_BAM):
        gender, info = gender_xy(f"{DIN}/panel.bam", 0.06, 0.09)
        assert [(k, v) for k, v in info] == [
            ("reads_chry", "2"), ("reads_chrx", "30645"), ("ratio_chry_chrx", "0.0001")]
        assert gender == "female"

    gender, info = gender_xy(f"{DIN}/Statistics_longread.bam", 0.06, 0.09)
    assert [(k, v) for k, v in info] == [
        ("reads_chry", "0"), ("reads_chrx", "214"), ("ratio_chry_chrx", "0.0000")]
    assert gender == "female"


def test_statistics_gender_hetx():
    """Statistics_Test.cpp:823-841 (genderHetX incl. long-read)."""
    from ngsbits_tpu.tools.sample_gender import gender_hetx

    import os
    if os.path.exists(PANEL_BAM):
        gender, _info = gender_hetx("hg19", f"{DIN}/panel.bam", 0.15, 0.24, False)
        assert gender == "unknown (too few SNPs)"

    gender, info = gender_hetx("hg38", f"{DIN}/Statistics_longread.bam", 0.15, 0.24, True)
    assert [(k, v) for k, v in info] == [
        ("snps_usable", "10 of 437"), ("hom_count", "10"),
        ("het_count", "0"), ("het_fraction", "0.0000")]
    assert gender == "unknown (too few SNPs)"


def test_statistics_gender_sry():
    """Statistics_Test.cpp:842-856 (genderSRY)."""
    from ngsbits_tpu.tools.sample_gender import gender_sry

    import os
    if os.path.exists(PANEL_BAM):
        gender, info = gender_sry("hg19", f"{DIN}/panel.bam", 20.0)
        assert [(k, v) for k, v in info] == [("coverage_sry", "0.00")]
        assert gender == "female"

    gender, info = gender_sry("hg19", f"{DIN}/sry.bam", 20.0)
    assert [(k, v) for k, v in info] == [("coverage_sry", "67.27")]
    assert gender == "male"


def test_statistics_ancestry():
    """Statistics_Test.cpp:857-882 (ancestry)."""
    from ngsbits_tpu.tools.sample_ancestry import ancestry

    snps, afr, eur, sas, eas, pop = ancestry("hg19", f"{DIN}/ancestry.vcf.gz")
    assert snps == 3096
    assert afr == pytest.approx(0.0114, abs=0.001)
    assert eur == pytest.approx(0.3088, abs=0.001)
    assert sas == pytest.approx(0.1636, abs=0.001)
    assert eas == pytest.approx(0.0572, abs=0.001)
    assert pop == "EUR"

    snps, *_rest, pop = ancestry("hg19", f"{DIN}/ancestry.vcf.gz", 10000)
    assert snps == 3096
    assert pop == "NOT_ENOUGH_SNPS"

    snps, afr, eur, sas, eas, pop = ancestry("hg19", f"{DIN}/ancestry.vcf.gz", 1000, 0.0, 2.0)
    assert snps == 3096
    assert pop == "ADMIXED/UNKNOWN"


def test_statistics_ancestry_hg38():
    """Statistics_Test.cpp:883-905 (ancestry_hg38)."""
    from ngsbits_tpu.tools.sample_ancestry import ancestry

    snps, afr, eur, sas, eas, pop = ancestry("hg38", f"{DIN}/ancestry_hg38.vcf.gz")
    assert snps == 2126
    assert afr == pytest.approx(0.4984, abs=0.001)
    assert eur == pytest.approx(0.0241, abs=0.001)
    assert sas == pytest.approx(0.1046, abs=0.001)
    assert eas == pytest.approx(0.0742, abs=0.001)
    assert pop == "AFR"


# ---- StatisticsReads_Test.cpp ---------------------------------------------

def test_statistics_reads():
    """StatisticsReads_Test.cpp:8-57 (reads)."""
    from ngsbits_tpu.io.fastq import FastqReader
    from ngsbits_tpu.qc.read_stats import FORWARD, REVERSE, ReadStatistics

    stats = ReadStatistics(single_end=False)
    for batch in FastqReader(f"{DIN}/example6.fastq.gz"):
        stats.update_batch(batch, FORWARD)
    for batch in FastqReader(f"{DIN}/example7.fastq.gz"):
        stats.update_batch(batch, REVERSE)
    result = list(stats.get_result())
    expected = [("read count", "5000"), ("read length", "151"),
                ("bases sequenced (MB)", "0.76"), ("Q20 read percentage", "99.40"),
                ("Q20 base percentage", "96.77"), ("Q30 base percentage", "96.30"),
                ("no base call percentage", "0.00"), ("gc content percentage", "46.26")]
    for i, (name, value) in enumerate(expected):
        assert result[i].name == name
        assert result[i].to_string() == value
    assert result[8].name == "base distribution plot"
    assert result[9].name == "Q score plot"
    assert result[10].name == "read Q score distribution"
    assert len(result) == 11
    for v in result:
        assert v.description != ""


# ---- Sequence_Test.cpp ----------------------------------------------------

def test_sequence_ops():
    """Sequence_Test.cpp (reverse/complement/reverseComplement/onlyACGT)."""
    from ngsbits_tpu.io.fasta import complement, only_acgt, reverse_complement

    assert b""[::-1] == b""
    assert b"ACGTN"[::-1] == b"NTGCA"
    assert complement(b"") == b""
    assert complement(b"ACGTN") == b"TGCAN"
    assert reverse_complement(b"") == b""
    assert reverse_complement(b"ACGTA") == b"TACGT"
    assert reverse_complement(b"ACGT") == b"ACGT"
    assert reverse_complement(b"ACGTN") == b"NACGT"
    assert reverse_complement(b"ACNT") == b"ANGT"
    assert only_acgt(b"ACGTACGTACGTACGT")
    assert only_acgt(b"A")
    assert not only_acgt(b"ACGTN")
    assert not only_acgt(b"N")
    assert not only_acgt(b"ACGTB")
    assert not only_acgt(b"B")


# ---- SomaticVariantInterpreter_Test.cpp ------------------------------------

def _vicc(**kwargs):
    from ngsbits_tpu.ngsd.somatic_vicc import SomaticViccData
    d = SomaticViccData()
    d.states.update(kwargs)
    return d


def test_vicc_data():
    """SomaticVariantInterpreter_Test.cpp:11-49 (SomaticViccDataTest)."""
    d = _vicc()
    assert d.is_valid()
    d.states["known_oncogenic_aa"] = True
    d.states["located_in_canerhotspot"] = False
    assert not d.is_valid()
    assert d.config_as_map()["known_oncogenic_aa"] == "TRUE"
    assert d.config_as_map()["located_in_canerhotspot"] == "FALSE"
    d.states["located_in_canerhotspot"] = None
    assert d.is_valid()
    assert d.config_as_map()["located_in_canerhotspot"] == "NOT_APPLICABLE"
    d.states["other_aa_known_oncogenic"] = False
    assert not d.is_valid()
    assert d.config_as_map()["other_aa_known_oncogenic"] == "FALSE"

    d = _vicc()
    assert d.strong_evidence_count() == 0
    d.states.update(known_oncogenic_aa=True, strong_cancerhotspot=True)
    assert d.strong_evidence_count() == 2
    assert d.moderate_evidence_count() == 0
    d.states.update(absent_from_controls=True, protein_length_change=True,
                    weak_cancerhotspot=True)
    assert d.moderate_evidence_count() == 3
    assert d.supporting_evidence_count() == 0
    d.states.update(computational_evidence=True)
    assert d.supporting_evidence_count() == 1


def test_vicc_rules_oncogenic():
    """SomaticVariantInterpreter_Test.cpp:51-117 (viccRulesOncogenic)."""
    from ngsbits_tpu.ngsd.somatic_vicc import vicc_score_as_string as score

    d = _vicc(null_mutation_in_tsg=True)
    assert score(d) == "UNCERTAIN_SIGNIFICANCE"
    d.states["oncogenic_functional_studies"] = True
    assert score(d) == "ONCOGENIC"
    assert score(_vicc(null_mutation_in_tsg=True, located_in_canerhotspot=True,
                       absent_from_controls=True)) == "ONCOGENIC"
    assert score(_vicc(null_mutation_in_tsg=True, protein_length_change=True,
                       very_weak_cancerhotspot=True)) == "ONCOGENIC"
    assert score(_vicc(null_mutation_in_tsg=True, computational_evidence=True,
                       mutation_in_gene_with_etiology=True)) == "ONCOGENIC"
    d = _vicc(strong_cancerhotspot=True)
    assert score(d) == "UNCERTAIN_SIGNIFICANCE"
    d.states["known_oncogenic_aa"] = True
    assert score(d) == "ONCOGENIC"
    assert score(_vicc(known_oncogenic_aa=True, protein_length_change=True,
                       weak_cancerhotspot=True, located_in_canerhotspot=True)) == "ONCOGENIC"
    assert score(_vicc(oncogenic_functional_studies=True, absent_from_controls=True,
                       other_aa_known_oncogenic=True, very_weak_cancerhotspot=True,
                       mutation_in_gene_with_etiology=True)) == "ONCOGENIC"
    assert score(_vicc(oncogenic_functional_studies=True, protein_length_change=True,
                       computational_evidence=True, mutation_in_gene_with_etiology=True,
                       very_weak_cancerhotspot=True)) == "ONCOGENIC"


def test_vicc_rules_likely_oncogenic():
    """SomaticVariantInterpreter_Test.cpp:119-165 (viccRulesLikelyOncogenic)."""
    from ngsbits_tpu.ngsd.somatic_vicc import vicc_score_as_string as score

    assert score(_vicc(null_mutation_in_tsg=True,
                       other_aa_known_oncogenic=True)) == "LIKELY_ONCOGENIC"
    assert score(_vicc(oncogenic_functional_studies=True,
                       weak_cancerhotspot=True)) == "LIKELY_ONCOGENIC"
    assert score(_vicc(known_oncogenic_aa=True, mutation_in_gene_with_etiology=True,
                       very_weak_cancerhotspot=True)) == "LIKELY_ONCOGENIC"
    assert score(_vicc(other_aa_known_oncogenic=True, absent_from_controls=True,
                       weak_cancerhotspot=True)) == "LIKELY_ONCOGENIC"
    assert score(_vicc(other_aa_known_oncogenic=True, absent_from_controls=True,
                       computational_evidence=True,
                       mutation_in_gene_with_etiology=True)) == "LIKELY_ONCOGENIC"
    assert score(_vicc(located_in_canerhotspot=True, computational_evidence=True,
                       mutation_in_gene_with_etiology=True,
                       very_weak_cancerhotspot=True)) == "LIKELY_ONCOGENIC"


def test_vicc_rules_benign_likely_benign_uncertain():
    """SomaticVariantInterpreter_Test.cpp:168-214 (viccRulesBenign/LikelyBenign/
    UncertainSignificance)."""
    from ngsbits_tpu.ngsd.somatic_vicc import vicc_score_as_string as score

    assert score(_vicc(very_high_maf=True)) == "BENIGN"
    assert score(_vicc(benign_functional_studies=True, high_maf=True)) == "BENIGN"
    assert score(_vicc(high_maf=True, synonymous_mutation=True,
                       benign_computational_evidence=True)) == "LIKELY_BENIGN"
    assert score(_vicc(null_mutation_in_tsg=True)) == "UNCERTAIN_SIGNIFICANCE"
    assert score(_vicc(oncogenic_functional_studies=True,
                       computational_evidence=True)) == "UNCERTAIN_SIGNIFICANCE"
    assert score(_vicc(absent_from_controls=True,
                       protein_length_change=True)) == "UNCERTAIN_SIGNIFICANCE"
    assert score(_vicc(benign_computational_evidence=True,
                       synonymous_mutation=True)) == "UNCERTAIN_SIGNIFICANCE"


def test_vicc_score_combined():
    """SomaticVariantInterpreter_Test.cpp:216-282 (viccScore)."""
    from ngsbits_tpu.ngsd.somatic_vicc import vicc_score_as_string as score

    assert score(_vicc(null_mutation_in_tsg=True,
                       oncogenic_functional_studies=True)) == "ONCOGENIC"
    assert score(_vicc(oncogenic_functional_studies=True,
                       weak_cancerhotspot=True)) == "LIKELY_ONCOGENIC"
    assert score(_vicc(null_mutation_in_tsg=True, oncogenic_functional_studies=True,
                       very_high_maf=True)) == "UNCERTAIN_SIGNIFICANCE"
    assert score(_vicc(null_mutation_in_tsg=True, oncogenic_functional_studies=True,
                       high_maf=True, synonymous_mutation=True,
                       benign_computational_evidence=True)) == "UNCERTAIN_SIGNIFICANCE"
    assert score(_vicc(null_mutation_in_tsg=True, other_aa_known_oncogenic=True,
                       very_high_maf=True)) == "UNCERTAIN_SIGNIFICANCE"
    assert score(_vicc(null_mutation_in_tsg=True, other_aa_known_oncogenic=True,
                       high_maf=True, synonymous_mutation=True,
                       benign_computational_evidence=True)) == "UNCERTAIN_SIGNIFICANCE"
    assert score(_vicc(very_high_maf=True)) == "BENIGN"
    assert score(_vicc(high_maf=True, synonymous_mutation=True,
                       benign_computational_evidence=True)) == "LIKELY_BENIGN"


def test_vicc_predict_parameters():
    """SomaticVariantInterpreter_Test.cpp:284-331 (predictViccParameters)."""
    from ngsbits_tpu.io.gsvar import GSvarFile
    from ngsbits_tpu.ngsd.somatic_vicc import predict_vicc_value

    vl = GSvarFile.from_file(f"{DIN}/SomaticVariantInterpreter_predict.GSvar")
    s = predict_vicc_value(vl, vl.variants[0]).states
    assert s["null_mutation_in_tsg"] is False
    assert s["strong_cancerhotspot"] is False
    assert s["absent_from_controls"] is True
    assert s["protein_length_change"] is False
    assert s["weak_cancerhotspot"] is False
    assert s["computational_evidence"] is False
    assert s["very_weak_cancerhotspot"] is False
    assert s["very_high_maf"] is False
    assert s["benign_functional_studies"] is False
    assert s["high_maf"] is False
    assert s["synonymous_mutation"] is False

    s = predict_vicc_value(vl, vl.variants[1]).states
    assert s["null_mutation_in_tsg"] is True

    s = predict_vicc_value(vl, vl.variants[2]).states
    assert s["known_oncogenic_aa"] is True
    assert s["strong_cancerhotspot"] is True
    assert s["absent_from_controls"] is True
    assert s["computational_evidence"] is True

    s = predict_vicc_value(vl, vl.variants[3]).states
    assert s["known_oncogenic_aa"] is False
    assert s["strong_cancerhotspot"] is True
    assert s["absent_from_controls"] is False
    assert s["weak_cancerhotspot"] is False
    assert s["computational_evidence"] is True
    assert s["very_high_maf"] is False
    assert s["high_maf"] is True

    s = predict_vicc_value(vl, vl.variants[4]).states
    assert s["very_high_maf"] is True
    assert s["benign_functional_studies"] is True
    assert s["high_maf"] is True
    assert s["synonymous_mutation"] is True


# ---- BedFile_Test.cpp ------------------------------------------------------

def _BL(chrom, start, end, annos=()):
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedLine
    return BedLine(Chromosome(chrom), start, end, [a.encode() for a in annos])


def _bf(*lines):
    from ngsbits_tpu.core.intervals import BedFile
    f = BedFile()
    for l in lines:
        f.append(l)
    return f


def _chk(line, chrom, start, end):
    from ngsbits_tpu.core.chromosome import Chromosome
    assert line.chr == Chromosome(chrom)
    assert (line.start, line.end) == (start, end)


def test_bedfile_is_sorted():
    """BedFile_Test.cpp:16-36 (isSorted)."""
    f = _bf()
    assert f.is_sorted()
    f.append(_BL("chr2", 5, 10))
    assert f.is_sorted()
    f.append(_BL("chr2", 15, 20))
    assert f.is_sorted()
    f.append(_BL("chr21", 1, 2))
    f.append(_BL("chr21", 15, 20))
    assert f.is_sorted()
    f.append(_BL("chr21", 15, 20))
    assert f.is_sorted()
    f.append(_BL("chr21", 6, 9))
    assert not f.is_sorted()


def test_bedfile_sort():
    """BedFile_Test.cpp:38-80 (sort)."""
    f = _bf()
    f.sort()
    assert len(f.lines) == 0
    f.append(_BL("chr2", 5, 10))
    f.sort()
    assert len(f.lines) == 1
    f.append(_BL("chr2", 15, 20))
    f.append(_BL("chr2", 1, 2))
    assert not f.is_sorted()
    f.sort()
    assert f.is_sorted()
    assert [l.start for l in f.lines] == [1, 5, 15]
    f.append(_BL("chr1", 14, 20))
    f.append(_BL("chr1", 7, 23))
    assert not f.is_sorted()
    f.sort()
    assert f.is_sorted()
    assert len(f.lines) == 5
    _chk(f[0], "chr1", 7, 23)
    _chk(f[1], "chr1", 14, 20)
    _chk(f[2], "chr2", 1, 2)
    _chk(f[3], "chr2", 5, 10)
    _chk(f[4], "chr2", 15, 20)


def test_bedfile_sort_with_name():
    """BedFile_Test.cpp:82-106 (sortWithName)."""
    f = _bf(_BL("chr1", 14, 20, ["X"]), _BL("chr1", 14, 20),
            _BL("chr1", 14, 20, ["Y"]), _BL("chr1", 7, 9, ["C"]),
            _BL("chr1", 7, 9, ["B"]), _BL("chr1", 7, 9, ["A"]))
    f.sort_with_name()
    assert f.is_sorted()
    assert len(f.lines) == 6
    assert f[0].annotations == [b"A"]
    assert f[1].annotations == [b"B"]
    assert f[2].annotations == [b"C"]
    assert f[3].annotations == []
    assert f[4].annotations == [b"X"]
    assert f[5].annotations == [b"Y"]


def test_bedfile_remove_duplicates():
    """BedFile_Test.cpp:108-133 (removeDuplicates)."""
    f = _bf(_BL("chr1", 7, 23), _BL("chr1", 7, 23), _BL("chr1", 14, 20),
            _BL("chr2", 1, 2), _BL("chr2", 1, 2), _BL("chr2", 5, 10),
            _BL("chr2", 15, 20))
    f.remove_duplicates()
    assert f.is_sorted()
    assert len(f.lines) == 5
    _chk(f[0], "chr1", 7, 23)
    _chk(f[1], "chr1", 14, 20)
    _chk(f[2], "chr2", 1, 2)
    _chk(f[3], "chr2", 5, 10)
    _chk(f[4], "chr2", 15, 20)


def test_bedfile_merge():
    """BedFile_Test.cpp:135-227 (merge incl. no-back-to-back + merge_names)."""
    f = _bf()
    f.merge()
    assert len(f.lines) == 0
    f.append(_BL("chr2", 5, 10))
    f.merge()
    assert len(f.lines) == 1
    f.append(_BL("chr2", 10, 20))
    f.append(_BL("chr2", 1, 2))
    f.merge()
    assert len(f.lines) == 2
    assert (f[0].start, f[0].end) == (1, 2)
    assert (f[1].start, f[1].end) == (5, 20)
    f.append(_BL("chr1", 14, 20))
    f.append(_BL("chr1", 7, 23))
    f.merge()
    assert len(f.lines) == 3
    _chk(f[0], "chr1", 7, 23)
    _chk(f[1], "chr2", 1, 2)
    _chk(f[2], "chr2", 5, 20)

    # no back-to-back
    f.append(_BL("chr1", 1, 6))
    f.append(_BL("chr1", 24, 30))
    f.merge(False)
    assert len(f.lines) == 5
    _chk(f[0], "chr1", 1, 6)
    _chk(f[1], "chr1", 7, 23)
    _chk(f[2], "chr1", 24, 30)
    _chk(f[3], "chr2", 1, 2)
    _chk(f[4], "chr2", 5, 20)

    # merge_names (without content)
    f.merge(True, True)
    assert len(f.lines) == 3
    _chk(f[0], "chr1", 1, 30)
    assert f[0].annotations == [b",,"]
    _chk(f[1], "chr2", 1, 2)
    assert f[1].annotations == [b""]
    _chk(f[2], "chr2", 5, 20)
    assert f[2].annotations == [b""]

    # merge_names (with content)
    f.append(_BL("chr1", 2, 31, ["bli"]))
    f.append(_BL("chr2", 2, 7, ["bla"]))
    f.append(_BL("chr2", 19, 25, ["bluff"]))
    f.merge(True, True)
    assert len(f.lines) == 2
    _chk(f[0], "chr1", 1, 31)
    assert f[0].annotations == [b",,,bli"]
    _chk(f[1], "chr2", 1, 25)
    assert f[1].annotations == [b",bla,,bluff"]


def test_bedfile_load():
    """BedFile_Test.cpp:229-290 (load with/without annotations)."""
    from ngsbits_tpu.core.intervals import BedFile

    f = BedFile.from_file(f"{DIN}/demo.bed", read_annotations=False)
    assert len(f.lines) == 591
    _chk(f[0], "chr4", 843451, 843572)
    assert f[0].annotations == []
    _chk(f[590], "chr22", 38565215, 38565443)
    assert f[590].annotations == []
    assert not f.is_sorted()

    f = BedFile.from_file(f"{DIN}/demo.bed", read_annotations=True)
    assert len(f.lines) == 591
    assert f[0].annotations == [b"some text annotation"]
    assert f[590].annotations == [b""]


def test_bedfile_store(tmp_path):
    """BedFile_Test.cpp:292-298 (store) — golden compare."""
    from ngsbits_tpu.core.intervals import BedFile

    f = BedFile.from_file(f"{DIN}/demo.bed")
    out = str(tmp_path / "BedFile_store01_out.bed")
    f.store(out)
    assert open(out, "rb").read() == open(
        f"{NGS_TEST}/data_out/BedFile_store01_out.bed", "rb").read()


def test_bedfile_is_merged():
    """BedFile_Test.cpp:300-336 (isMerged/isMergedAndSorted)."""
    f = _bf()
    assert f.is_merged()
    f.append(_BL("chr2", 5, 10))
    assert f.is_merged()
    f.append(_BL("chr2", 15, 20))
    assert f.is_merged()
    f.append(_BL("chr21", 5, 10))
    f.append(_BL("chr21", 15, 20))
    assert f.is_merged()
    f.append(_BL("chr21", 10, 20))
    assert not f.is_merged()

    f = _bf()
    assert f.is_merged_and_sorted()
    f.append(_BL("chr2", 5, 10))
    assert f.is_merged_and_sorted()
    f.append(_BL("chr2", 15, 20))
    assert f.is_merged_and_sorted()
    f.append(_BL("chr21", 15, 20))
    f.append(_BL("chr21", 5, 10))
    assert not f.is_merged_and_sorted()
    f.sort()
    assert f.is_merged_and_sorted()
    f.append(_BL("chr21", 10, 15))
    assert not f.is_merged_and_sorted()


def test_bedfile_extend_shrink():
    """BedFile_Test.cpp:337-358, 425-448 (extend/shrink)."""
    f = _bf(_BL("chr1", 15, 20), _BL("chr2", 5, 10), _BL("chr21", 200, 200))
    f.extend(10)
    assert len(f.lines) == 3
    _chk(f[0], "chr1", 5, 30)
    _chk(f[1], "chr2", 1, 20)
    _chk(f[2], "chr21", 190, 210)

    f = _bf(_BL("chr11", 1, 2), _BL("chr13", 10, 20), _BL("chr16", 1, 3),
            _BL("chr16", 4, 10))
    f.shrink(1)
    assert len(f.lines) == 3
    _chk(f[0], "chr13", 11, 19)
    _chk(f[1], "chr16", 2, 2)
    _chk(f[2], "chr16", 5, 9)
    f.shrink(2)
    assert len(f.lines) == 2
    _chk(f[0], "chr13", 13, 17)
    _chk(f[1], "chr16", 7, 7)
    f.shrink(3)
    assert len(f.lines) == 0


def test_bedfile_subtract():
    """BedFile_Test.cpp:360-423 (subtract/subtract2)."""
    f1 = _bf(_BL("chr2", 1, 100), _BL("chr1", 5, 9), _BL("chr1", 9, 20),
             _BL("chr1", 8, 22), _BL("chr1", 10, 20), _BL("chr1", 10, 21))
    f2 = _bf(_BL("chr1", 10, 20))
    f1.subtract(f2)
    assert len(f1.lines) == 6
    _chk(f1[0], "chr2", 1, 100)
    _chk(f1[1], "chr1", 5, 9)
    _chk(f1[2], "chr1", 9, 9)
    _chk(f1[3], "chr1", 8, 9)
    _chk(f1[4], "chr1", 21, 21)
    _chk(f1[5], "chr1", 21, 22)

    f1 = _bf(_BL("chr11", 5000000, 6000000), _BL("chr13", 45000000, 46000000),
             _BL("chr16", 71000000, 72000000), _BL("chr16", 73000000, 74000000))
    f2 = _bf(_BL("chr11", 5012596, 5012620), _BL("chr11", 5462579, 5462675),
             _BL("chr11", 5462707, 5462748), _BL("chr13", 45553329, 45553489),
             _BL("chr16", 71196324, 71196420), _BL("chr16", 71196480, 71196576))
    f1.subtract(f2)
    f1.merge()
    assert len(f1.lines) == 10
    _chk(f1[0], "chr11", 5000000, 5012595)
    _chk(f1[1], "chr11", 5012621, 5462578)
    _chk(f1[2], "chr11", 5462676, 5462706)
    _chk(f1[3], "chr11", 5462749, 6000000)
    _chk(f1[4], "chr13", 45000000, 45553328)
    _chk(f1[5], "chr13", 45553490, 46000000)
    _chk(f1[6], "chr16", 71000000, 71196323)
    _chk(f1[7], "chr16", 71196421, 71196479)
    _chk(f1[8], "chr16", 71196577, 72000000)
    _chk(f1[9], "chr16", 73000000, 74000000)


def test_bedfile_intersect_overlapping():
    """BedFile_Test.cpp:450-516 (intersect/overlapping)."""
    from ngsbits_tpu.core.intervals import BedFile

    f1, f2 = BedFile(), BedFile()
    f1.intersect(f2)
    assert len(f1.lines) == 0
    f1.append(_BL("chr1", 5, 9))
    f1.append(_BL("chr1", 10, 20))
    f1.append(_BL("chr2", 1, 100))
    f2.intersect(f1)
    assert len(f2.lines) == 0
    f1.append(_BL("chr1", 10, 21))
    f1.append(_BL("chr1", 8, 22))
    f1.append(_BL("chr1", 9, 20))
    f1.sort()
    f2.append(_BL("chr1", 5, 8))
    f2.append(_BL("chr1", 21, 50))
    f1.intersect(f2)
    assert len(f1.lines) == 4
    _chk(f1[0], "chr1", 5, 8)
    _chk(f1[1], "chr1", 8, 8)
    _chk(f1[2], "chr1", 21, 21)
    _chk(f1[3], "chr1", 21, 22)

    f1, f2 = BedFile(), BedFile()
    f1.overlapping(f2)
    assert len(f1.lines) == 0
    f1.append(_BL("chr1", 5, 9))
    f1.append(_BL("chr1", 10, 20))
    f1.append(_BL("chr2", 1, 100))
    f2.overlapping(f1)
    assert len(f2.lines) == 0
    f1.append(_BL("chr1", 10, 21))
    f1.append(_BL("chr1", 8, 22))
    f1.append(_BL("chr1", 9, 20))
    f1.sort()
    f2.append(_BL("chr1", 5, 8))
    f2.append(_BL("chr1", 21, 50))
    f1.overlapping(f2)
    assert len(f1.lines) == 3
    _chk(f1[0], "chr1", 5, 9)
    _chk(f1[1], "chr1", 8, 22)
    _chk(f1[2], "chr1", 10, 21)


def test_bedfile_chunk():
    """BedFile_Test.cpp:518-565 (chunk)."""
    from ngsbits_tpu.core.intervals import BedFile

    f = _bf(_BL("chr1", 100, 110, ["1"]), _BL("chr2", 200, 219),
            _BL("chr3", 250, 270), _BL("chr4", 300, 330, ["1", "2", "3"]),
            _BL("chr5", 400, 440), _BL("chr6", 500, 550), _BL("chr7", 600, 660),
            _BL("chr8", 700, 770), _BL("chr9", 800, 880), _BL("chr10", 900, 990))
    f.chunk(15)
    assert len(f.lines) == 32
    _chk(f[0], "chr1", 100, 110)
    assert f[0].annotations == [b"1"]
    _chk(f[1], "chr2", 200, 219)
    assert f[1].annotations == []
    _chk(f[2], "chr3", 250, 259)
    _chk(f[3], "chr3", 260, 270)
    _chk(f[4], "chr4", 300, 315)
    assert f[4].annotations == [b"1", b"2", b"3"]
    _chk(f[5], "chr4", 316, 330)
    assert f[5].annotations == [b"1", b"2", b"3"]

    f = BedFile.from_file(f"{DIN}/demo.bed", read_annotations=False)
    f.merge()
    assert len(f.lines) == 591
    import copy
    f2 = copy.deepcopy(f)
    f2.chunk(15)
    assert len(f2.lines) == 6119
    f2.merge()
    assert len(f2.lines) == 591
    for a, b in zip(f.lines, f2.lines):
        assert (a.chr, a.start, a.end) == (b.chr, b.start, b.end)


def test_bedfile_chromosomes_fromtext_overlaps():
    """BedFile_Test.cpp:567-641 (chromosomes/fromText/overlapsWith*)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile

    f = _bf(_BL("chr1", 100, 110))
    expected = {Chromosome("chr1")}
    assert f.chromosomes() == expected
    f.append(_BL("chr2", 100, 110))
    expected.add(Chromosome("chr2"))
    assert f.chromosomes() == expected
    f.append(_BL("chr2", 200, 210))
    assert f.chromosomes() == expected
    f.append(_BL("chr1", 200, 210))
    assert f.chromosomes() == expected
    f.append(_BL("chr3", 100, 110))
    expected.add(Chromosome("chr3"))
    assert f.chromosomes() == expected

    f = BedFile.from_text("#bla\n#track name='dummy'\nchr1\t0\t99\n\nchr2\t0\t99")
    assert f.headers == [b"#bla", b"#track name='dummy'"]
    assert len(f.lines) == 2
    assert f.base_count() == 198

    f = BedFile.from_text("chr1\t0\t99\n\nchr2\t0\t99")
    assert not f.overlaps_with(Chromosome("chr3"), 1, 100)
    assert f.overlaps_with(Chromosome("chr1"), 1, 20)
    assert f.overlaps_with(Chromosome("chr2"), 50, 150)

    assert not f.overlaps_with_file(BedFile.from_text("chr3\t1\t12\n\nchr4\t0\t99"))
    assert f.overlaps_with_file(BedFile.from_text("chr1\t1\t12\n\nchr3\t0\t99"))
    assert f.overlaps_with_file(BedFile.from_text("chr1\t200\t212\n\nchr1\t0\t99"))
    assert f.overlaps_with_file(BedFile.from_text("chr3\t0\t99\nchr1\t1\t12\n"))
    assert f.overlaps_with_file(BedFile.from_text("chr1\t0\t99\nchr1\t200\t212\n"))


# ---- GeneSet_Test.cpp ------------------------------------------------------

def test_geneset_count_and_index():
    """GeneSet_Test.cpp:8-52 (count)."""
    from ngsbits_tpu.core.geneset import GeneSet

    s = GeneSet()
    assert len(s) == 0
    s.insert("")
    assert len(s) == 0
    s.insert("A")
    assert len(s) == 1
    s.insert("a")
    assert len(s) == 1
    s.insert("C")
    assert len(s) == 2
    s.insert("C")
    assert len(s) == 2
    s.insert("B")
    assert len(s) == 3
    for g in ("B", "A", "C", "B", " ", ""):
        s.insert(g)
    assert len(s) == 3
    assert (s[0], s[1], s[2]) == ("A", "B", "C")


def test_geneset_clear_contains():
    """GeneSet_Test.cpp:54-76 (clear/contains)."""
    from ngsbits_tpu.core.geneset import GeneSet

    s = GeneSet()
    s.insert("A")
    assert len(s) == 1
    s.clear()
    assert len(s) == 0

    s = GeneSet()
    s.insert("A")
    assert s.contains("A")
    assert s.contains("a")
    assert not s.contains("B")
    assert not s.contains("C")


def test_geneset_contains_all_intersects():
    """GeneSet_Test.cpp:78-142 (containsAll/intersectsWith/intersect)."""
    from ngsbits_tpu.core.geneset import GeneSet

    s, s2 = GeneSet(), GeneSet()
    assert s.contains_all(s2)
    assert s2.contains_all(s)
    s.insert_all(["A", "B"])
    assert s.contains_all(s2)
    assert not s2.contains_all(s)
    s2.insert_all(["C", "D", "A", "B"])
    assert not s.contains_all(s2)
    assert s2.contains_all(s)

    s, s2 = GeneSet(), GeneSet()
    s.insert_all(["A", "B"])
    s2.insert_all(["C", "D"])
    assert not s.intersects_with(s2)
    assert not s2.intersects_with(s)
    s2.insert("B")
    assert s.intersects_with(s2)
    assert s2.intersects_with(s)

    s, s2 = GeneSet(), GeneSet()
    s.insert_all(["A", "B"])
    s2.insert_all(["C", "D"])
    assert len(s.intersect(s2)) == 0
    assert len(s2.intersect(s)) == 0
    s2.insert("B")
    inter = s.intersect(s2)
    assert len(inter) == 1 and inter[0] == "B"
    inter = s2.intersect(s)
    assert len(inter) == 1 and inter[0] == "B"
    s.insert("C")
    inter = s.intersect(s2)
    assert (len(inter), inter[0], inter[1]) == (2, "B", "C")


def test_geneset_create_and_store(tmp_path):
    """GeneSet_Test.cpp:144-262 (createFromFile/Text/StringList, store,
    toString)."""
    from ngsbits_tpu.core.geneset import GeneSet

    s = GeneSet.create_from_file(f"{DIN}/GeneSet_in1.tsv")
    assert (len(s), s[0], s[1], s[2]) == (3, "A", "B", "C")

    s = GeneSet.create_from_text("#bla\nA\nC\nB")
    assert (len(s), s[0], s[1], s[2]) == (3, "A", "B", "C")

    s = GeneSet.create_from_text("#bla,A,C,B", ",")
    assert (len(s), s[0], s[1], s[2]) == (3, "A", "B", "C")

    s = GeneSet()
    for g in ("B", "A", "C", "a"):
        s.insert(g)
    out = str(tmp_path / "GeneSet_store.tsv")
    s.store(out)
    assert open(out).read().split("\n")[:3] == ["A", "B", "C"]

    s = GeneSet.create_from_text("A,C,B", ",")
    assert s.join(", ") == "A, B, C"


def test_geneset_remove():
    """GeneSet_Test.cpp:264-310 (remove single/list/set)."""
    from ngsbits_tpu.core.geneset import GeneSet

    s = GeneSet()
    s.insert_all(["A", "B", "C", "D"])
    s.remove("b")
    assert len(s) == 3
    assert not s.contains("B")

    s = GeneSet()
    s.insert_all(["A", "B", "C", "D"])
    s.remove_all(["B", "D"])
    assert len(s) == 2
    assert not s.contains("B")
    assert not s.contains("D")


# ---- Chromosome_Test.cpp ---------------------------------------------------

def test_chromosome_str_and_normalized():
    """Chromosome_Test.cpp:8-38 (str/strNormalized)."""
    from ngsbits_tpu.core.chromosome import Chromosome

    assert Chromosome("1").str == "1"
    assert Chromosome("chr1").str == "chr1"
    assert Chromosome("CHRX").str == "CHRX"
    assert Chromosome("chrY").str == "chrY"
    assert Chromosome("M").str == "M"
    assert Chromosome("MT").str == "MT"
    assert Chromosome(b"1").str == "1"

    assert Chromosome("1").str_normalized(False) == "1"
    assert Chromosome("chr1").str_normalized(False) == "1"
    assert Chromosome("chr01").str_normalized(False) == "01"
    assert Chromosome("CHRX").str_normalized(False) == "X"
    assert Chromosome("chrY").str_normalized(False) == "Y"
    assert Chromosome("M").str_normalized(False) == "MT"
    assert Chromosome("MT").str_normalized(False) == "MT"
    assert Chromosome("1").str_normalized(True) == "chr1"
    assert Chromosome("chr1").str_normalized(True) == "chr1"
    assert Chromosome("CHRX").str_normalized(True) == "chrX"
    assert Chromosome("chrY").str_normalized(True) == "chrY"
    assert Chromosome("M").str_normalized(True) == "chrMT"
    assert Chromosome("MT").str_normalized(True) == "chrMT"


def test_chromosome_num_and_predicates():
    """Chromosome_Test.cpp:40-140 (num/isNonSpecial/isAutosome/isGonosome/
    isX/isY/isM)."""
    from ngsbits_tpu.core.chromosome import Chromosome

    assert Chromosome("1").num == 1
    assert Chromosome("chr1").num == 1
    assert Chromosome("X").num == 1001
    assert Chromosome("CHRX").num == 1001
    assert Chromosome("Y").num == 1002
    assert Chromosome("chrY").num == 1002
    assert Chromosome("M").num == 1003
    assert Chromosome("MT").num == 1003
    base = Chromosome("chrBLA").num
    assert base >= 1004
    assert Chromosome("chrBLA2").num == base + 1
    assert Chromosome("BLA").num == base
    assert Chromosome("BLA2").num == base + 1
    assert Chromosome("chr01").num >= 1004

    for c in ("1", "chr1", "X", "CHRX", "Y", "chrY", "M", "MT"):
        assert Chromosome(c).is_non_special()
    for c in ("chrBLA2", "BLA", "BLA2", "chr01"):
        assert not Chromosome(c).is_non_special()

    for c in ("", "X", "Y", "M", "BLA"):
        assert not Chromosome(c).is_autosome()
    for c in ("1", "2", "10", "20", "22", "100"):
        assert Chromosome(c).is_autosome()

    assert Chromosome("X").is_gonosome()
    assert Chromosome("Y").is_gonosome()
    for c in ("", "M", "BLA", "1"):
        assert not Chromosome(c).is_gonosome()

    assert Chromosome("X").is_x()
    for c in ("Y", "", "M", "BLA", "1"):
        assert not Chromosome(c).is_x()
    assert Chromosome("y").is_y()
    for c in ("X", "", "M", "BLA", "1"):
        assert not Chromosome(c).is_y()
    assert Chromosome("M").is_m()
    assert Chromosome("MT").is_m()
    for c in ("X", "Y", "", "BLA", "1"):
        assert not Chromosome(c).is_m()


# ---- QCCollection_Test.cpp -------------------------------------------------

def test_qcvalue_constructors():
    """QCCollection_Test.cpp:8-38 (QCValue constructors)."""
    from ngsbits_tpu.core.qcml import QCType, QCValue

    v = QCValue.from_string("name", "bla", "desc", "QC:???????")
    assert v.type == QCType.STRING
    assert v.to_string() == "bla"

    v = QCValue.from_double("name", 14.56, "desc", "QC:???????")
    assert v.type == QCType.DOUBLE
    assert v.as_double() == pytest.approx(14.56)
    assert v.to_string() == "14.56"

    v = QCValue.from_int("name", 5147483647, "desc", "QC:???????")
    assert v.type == QCType.INT
    assert v.as_int() == 5147483647
    assert v.to_string() == "5147483647"

    v = QCValue.from_int("name", 4711, "desc", "QC:???????")
    assert v.as_int() == 4711
    assert v.to_string() == "4711"


def test_qccollection_from_qcml():
    """QCCollection_Test.cpp:55-110 (fromQCML incl. error list)."""
    from ngsbits_tpu.core.qcml import QCType
    from ngsbits_tpu.tools.qc_tools import qc_from_qcml

    errors: list[str] = []
    col = qc_from_qcml(f"{DIN}/qcML_infile_test.qcML", errors=errors)
    assert len(col) == 4

    v = col.value("QC:2000040", True)
    assert v.type == QCType.DOUBLE
    assert v.as_double() == pytest.approx(5.0)
    assert v.to_string(3) == "5.000"

    v = col.value("QC:2000006", True)
    assert v.type == QCType.STRING
    assert v.to_string() == "100+8+8+100"

    v = col.value("QC:2000117", True)
    assert v.type == QCType.INT
    assert v.as_int() == 17
    assert v.to_string() == "17"

    v = col.value("QC:2000011", True)
    assert v.type == QCType.IMAGE
    assert v.to_string().startswith("iVBORw0KGgo")

    assert errors == [
        "Skipped metric with unknown accession (accession=QC:9999999/unknown)",
        "Skipped metric with invalid integer value 'bla' (accession=QC:2000113/CNV count)",
        "Skipped metric with invalid float value 'bla' "
        "(accession=QC:2000114/coverage profile correlation)",
    ]


# ---- NGSHelper_Test.cpp ----------------------------------------------------

def test_ngshelper_pseudoautosomal_region():
    """NGSHelper_Test.cpp:206-211 (pseudoAutosomalRegion)."""
    from ngsbits_tpu.core.resources import pseudoautosomal_regions

    par = pseudoautosomal_regions("hg19")
    assert len(par.lines) == 4
    assert par.base_count() == 5938074


def test_ngshelper_cyto_band():
    """NGSHelper_Test.cpp:213-232 (cytoBand/cytoBandToRange)."""
    from ngsbits_tpu.core.genome_regions import cyto_band, cyto_band_to_range

    assert cyto_band("hg19", "chrY", 34847524) == b"Yq12"
    assert cyto_band("hg19", "chr1", 76992611) == b"1p31.1"

    for bad in ("", "Zr36.33", "1r36.33", "1p36.33-", "1p36.33-5q21.2",
                "1p36.33-1p36.32-1p36.31"):
        with pytest.raises(ValueError):
            cyto_band_to_range("hg19", bad)

    assert cyto_band_to_range("hg19", "chr1p36.33").to_string(True) == "chr1:1-2300000"
    assert cyto_band_to_range("hg19", "1p36.33").to_string(True) == "chr1:1-2300000"
    assert cyto_band_to_range("hg19", "1p36.33-1p36.32").to_string(True) == "chr1:1-5400000"
    assert cyto_band_to_range("hg19", "1p36.32-1p36.33").to_string(True) == "chr1:1-5400000"


def test_ngshelper_imprinting_genes():
    """NGSHelper_Test.cpp:234-245 (impringGenes)."""
    from ngsbits_tpu.core.genome_regions import imprinting_genes

    imp = imprinting_genes()
    assert len(imp) == 247
    assert imp[b"NPAP1"] == (b"paternal", b"imprinted")
    assert imp[b"NTM"] == (b"maternal", b"imprinted")
    assert imp[b"SALL1"] == (b"maternal", b"predicted")


def test_ngshelper_centromeres_telomeres():
    """NGSHelper_Test.cpp:247-270 (centromeres/telomeres)."""
    from ngsbits_tpu.core.genome_regions import centromeres, telomeres

    c19 = centromeres("hg19")
    assert len(c19.lines) == 24
    assert c19[1].to_string(True) == "chr2:92326171-95326171"
    assert c19[11].to_string(True) == "chr12:34856694-37856694"
    c38 = centromeres("hg38")
    assert len(c38.lines) == 24
    assert c38[0].to_string(True) == "chr1:121700000-125100000"

    t19 = telomeres("hg19")
    assert len(t19.lines) == 46
    assert t19[45].to_string(True) == "chrY:59363566-59373566"
    t38 = telomeres("hg38")
    assert len(t38.lines) == 48
    assert t38[32].to_string(True) == "chr17:1-10000"
    assert t38[45].to_string(True) == "chrX:156030895-156040895"


def test_ngshelper_population_codes():
    """NGSHelper_Test.cpp:271-279 (populationCodeToHumanReadable)."""
    from ngsbits_tpu.core.genome_regions import population_code_to_human_readable as f

    assert f("") == ""
    assert f("EUR") == "European"
    assert f("AFR") == "African"
    assert f("SAS") == "South asian"
    assert f("EAS") == "East asian"
    assert f("ADMIXED/UNKNOWN") == "Admixed/Unknown"


# ---- ChromosomalIndex_Test.cpp ---------------------------------------------

def _index_fixture():
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine, ChromosomalIndex
    bed = BedFile()
    for c in range(1, 23):
        for p in range(1, 100 * c + 1):
            end = p + 10 if p % 10 == 0 else p
            bed.append(BedLine(Chromosome(f"chr{c}"), p, end))
    return bed, ChromosomalIndex(bed), Chromosome


def test_chromosomal_index_matching_indices():
    """ChromosomalIndex_Test.cpp:10-59 (matchingIndices_BedFile)."""
    _bed, idx, Chromosome = _index_fixture()
    assert len(idx.matching_indices(Chromosome("chrX"), 5, 15)) == 0
    assert len(idx.matching_indices(Chromosome("chr1"), 0, 100000)) == 100
    assert len(idx.matching_indices(Chromosome("chr1"), 5, 7)) == 3
    assert len(idx.matching_indices(Chromosome("chr1"), 5, 5)) == 1
    assert len(idx.matching_indices(Chromosome("chr2"), 0, 100000)) == 200
    assert len(idx.matching_indices(Chromosome("chr2"), 1, 5)) == 5
    assert len(idx.matching_indices(Chromosome("chr2"), -10, 5)) == 5
    assert len(idx.matching_indices(Chromosome("chr2"), 200, 205)) == 2
    assert len(idx.matching_indices(Chromosome("chr2"), 500, 505)) == 0


def test_chromosomal_index_matching_index():
    """ChromosomalIndex_Test.cpp:61-112 (matchingIndex_BedFile)."""
    bed, idx, Chromosome = _index_fixture()
    assert idx.matching_index(Chromosome("chrX"), 5, 15) == -1
    assert idx.matching_index(Chromosome("chr1"), 0, 100000) == 0
    assert idx.matching_index(Chromosome("chr1"), 5, 7) == 4
    assert idx.matching_index(Chromosome("chr1"), 5, 5) == 4
    assert idx.matching_index(Chromosome("chr2"), 0, 100000) == 100
    assert idx.matching_index(Chromosome("chr2"), 1, 5) == 100
    assert idx.matching_index(Chromosome("chr2"), -10, 5) == 100
    i = idx.matching_index(Chromosome("chr2"), 200, 205)
    assert i == 289
    assert bed[i].chr == Chromosome("chr2")
    assert (bed[i].start, bed[i].end) == (190, 200)
    assert idx.matching_index(Chromosome("chr2"), 500, 505) == -1


# ---- StructuralVariantType_Test.cpp ----------------------------------------

def test_sv_type_string_conversion():
    """StructuralVariantType_Test.cpp:8-15 (stringConversion round-trip)."""
    from ngsbits_tpu.io.bedpe import type_to_full_string

    # DEL/DUP/INS/INV/BND map to distinct full strings (round-trip identity)
    full = {t: type_to_full_string(t) for t in (b"DEL", b"DUP", b"INS", b"INV", b"BND")}
    assert len(set(full.values())) == 5


# ---- BedLine_Test.cpp ------------------------------------------------------

def test_bedline_validity_overlap_adjacent():
    """BedLine_Test.cpp:8-74 (isValid/overlapsWith/adjacentTo)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedLine

    assert not BedLine(Chromosome(""), 0, 0).is_valid()
    line = _BL("chr1", 5, 10)
    assert line.is_valid()

    assert not line.overlaps(Chromosome("chr2"), 5, 10)
    assert not line.overlaps(Chromosome("chr1"), 1, 4)
    assert not line.overlaps(Chromosome("chr1"), 11, 20)
    for s, e in ((1, 5), (5, 10), (6, 8), (10, 20), (1, 20)):
        assert line.overlaps(Chromosome("chr1"), s, e)
    # position-only overload
    assert line.overlaps(None, 5, 10)
    assert not line.overlaps(None, 1, 4)

    assert not line.adjacent_to(1, 3)
    assert not line.adjacent_to(12, 15)
    assert line.adjacent_to(11, 20)
    assert line.adjacent_to(1, 4)


def test_bedline_sort_order_and_strings():
    """BedLine_Test.cpp:75-95 (operator< / fromString/toString)."""
    a = _BL("chr1", 1, 20)
    assert not (a.sort_key() < _BL("chr1", 1, 20).sort_key())
    assert a.sort_key() < _BL("chr1", 5, 20).sort_key()
    assert not (_BL("chr2", 1, 20).sort_key() < a.sort_key())
    assert a.sort_key() < _BL("chr2", 5, 20).sort_key()

    assert _BL("chr1", 1, 20).to_string() == "chr1:1-20"
    assert _BL("chr15", 3589921, 3699921).to_string(True) == "chr15:3589921-3699921"


# ---- CnvList_Test.cpp ------------------------------------------------------

def test_cnvlist_load_and_metadata():
    """CnvList_Test.cpp:9-77 (load/loadHeaderOnly/caller metadata + store)."""
    from ngsbits_tpu.io.cnv import CnvList

    cnvs = CnvList.from_file(f"{DIN}/CnvList_ClinCNV_germline.tsv")
    assert len(cnvs.comments) == 7
    assert cnvs.build() == "GRCh38"
    assert len(cnvs) == 67
    assert cnvs.qc_metric("number of iterations") == "1"
    assert cnvs.caller_as_string() == "ClinCNV"
    assert cnvs.caller_version() == "v1.18.3"
    assert cnvs.calling_date() == "2025-05-28"

    cnvs = CnvList.from_file(f"{DIN}/CnvList_ClinCNV_germline_multi.tsv",
                             header_only=True)
    assert len(cnvs.comments) == 17
    assert cnvs.build() == "GRCh38"
    assert len(cnvs) == 0


@pytest.mark.parametrize("name,version,date", [
    ("CnvList_ClinCNV_germline", "v1.18.3", "2025-05-28"),
    ("CnvList_ClinCNV_germline_multi", "v1.16.0", "2019-07-30"),
    ("CnvList_ClinCNV_somatic", "v1.18.3", "2025-05-27"),
])
def test_cnvlist_store_golden(tmp_path, name, version, date):
    """CnvList_Test.cpp basic_test_* — load/store round-trip vs data_out."""
    from ngsbits_tpu.io.cnv import CnvList

    cnvs = CnvList.from_file(f"{DIN}/{name}.tsv")
    assert cnvs.build() == "GRCh38"
    assert cnvs.caller_as_string() == "ClinCNV"
    assert cnvs.caller_version() == version
    assert cnvs.calling_date() == date
    out = str(tmp_path / f"{name}.tsv")
    cnvs.store(out)
    assert open(out, "rb").read() == open(
        f"{NGS_TEST}/data_out/{name}.tsv", "rb").read()


def test_cnvlist_find_match():
    """CnvList_Test.cpp:78-95 (findMatch exact/cn-constrained/fuzzy)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.io.cnv import CnvList, CopyNumberVariant

    cnvs = CnvList.from_file(f"{DIN}/CnvList_ClinCNV_germline.tsv")

    def cv(s, e):
        return CopyNumberVariant(Chromosome("chr1"), s, e)

    assert cnvs.find_match(cv(1534694, 1551033)) == 12
    assert cnvs.find_match(cv(1534694, 1551033), 3) == 12
    assert cnvs.find_match(cv(1534694, 1551033), 1) == -1
    assert cnvs.find_match(cv(1535194, 1552533), 3) == -1
    assert cnvs.find_match(cv(1535194, 1552533), 3, True) == 12
    assert cnvs.find_match(cv(1535194, 1552533), -3, True) == 12
    assert cnvs.find_match(cv(1535194, 1553533), 3, True) == -1


# ---- FastqFileStream_Test.cpp ----------------------------------------------

def _trim_quality(bases: bytes, quals: bytes, cutoff: int):
    """Drive the batched SeqPurge trimQuality kernel for one read."""
    from ngsbits_tpu.qc.seqpurge import SeqPurgeEngine, SeqPurgeParams
    eng = SeqPurgeEngine(SeqPurgeParams(qcut=cutoff, ncut=0, min_len=1))
    L = max(len(bases), 1)
    b = np.zeros((1, L), np.uint8)
    q = np.zeros((1, L), np.uint8)
    b[0, :len(bases)] = np.frombuffer(bases, np.uint8)
    q[0, :len(quals)] = np.frombuffer(quals, np.uint8)
    lens = np.array([len(bases)], np.int32)
    new_len = int(eng.trim_quality(q, lens)[0])
    return len(bases) - new_len, bases[:new_len], quals[:new_len]


def _trim_n(bases: bytes, quals: bytes, num_n: int):
    from ngsbits_tpu.qc.seqpurge import SeqPurgeEngine, SeqPurgeParams
    eng = SeqPurgeEngine(SeqPurgeParams(qcut=0, ncut=num_n, min_len=1))
    L = max(len(bases), 1)
    b = np.zeros((1, L), np.uint8)
    b[0, :len(bases)] = np.frombuffer(bases, np.uint8)
    lens = np.array([len(bases)], np.int32)
    new_len = int(eng.trim_n(b, lens)[0])
    return len(bases) - new_len, bases[:new_len], quals[:new_len]


def test_fastq_entry_trim_quality():
    """FastqFileStream_Test.cpp:9-68 (entry_trimQuality) — every pinned case
    through the batched kernel."""
    cases = [
        (b"", b"", 0, b"", b""),
        (b"ACG", b"###", 0, b"ACG", b"###"),
        (b"ACGTA", b"IIIII", 0, b"ACGTA", b"IIIII"),
        (b"ACGTA", b"#####", 5, b"", b""),
        (b"ACGTACGTACGTACGTACGTACGTACGTACGT",
         b"IIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII", 0,
         b"ACGTACGTACGTACGTACGTACGTACGTACGT",
         b"IIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII"),
        (b"ACGTACGTACGTACGTACGTACGTACGTACGT",
         b"IIIIIIIIIIIIIIIIIIIIIIIIIII#####", 5,
         b"ACGTACGTACGTACGTACGTACGTACG", b"IIIIIIIIIIIIIIIIIIIIIIIIIII"),
        (b"ACGTACGTACGTACGTACGTACGTACGTACGT",
         b"?????????????????????:50+#######", 8,
         b"ACGTACGTACGTACGTACGTACGT", b"?????????????????????:50"),
    ]
    for bases, quals, removed, exp_b, exp_q in cases:
        r, got_b, got_q = _trim_quality(bases, quals, 15)
        assert (r, got_b, got_q) == (removed, exp_b, exp_q), bases


def test_fastq_entry_trim_n():
    """FastqFileStream_Test.cpp:70-128 (entry_trimN)."""
    cases = [
        (b"", b"", 0, b"", b""),
        (b"ACG", b"###", 0, b"ACG", b"###"),
        (b"ACGTANNNNNN", b"IIIIIABCDEF", 0, b"ACGTANNNNNN", b"IIIIIABCDEF"),
        (b"ACGTANNNNNNN", b"IIIIIABCDEFG", 7, b"ACGTA", b"IIIII"),
        (b"ACGTANNNNNNANNNNNNN", b"IIIIIABCDEFGABCDEFG", 7,
         b"ACGTANNNNNNA", b"IIIIIABCDEFG"),
        (b"NNNNNNNACGTANNNNNNA", b"IIIIIABCDEFGABCDEFG", 19, b"", b""),
        (b"ACGTANNNNNNNNNNNNNN", b"IIIIIABCDEAFGABCDEF", 14, b"ACGTA", b"IIIII"),
    ]
    for bases, quals, removed, exp_b, exp_q in cases:
        r, got_b, got_q = _trim_n(bases, quals, 7)
        assert (r, got_b, got_q) == (removed, exp_b, exp_q), bases


def test_fastq_stream_read_gzipped():
    """FastqFileStream_Test.cpp:130-182 (read_gzipped) — record fields of the
    example file, batched reader."""
    from ngsbits_tpu.io.fastq import FastqReader

    reader = FastqReader(f"{DIN}/example1.fastq.gz", keep_headers=True)
    records = []
    for batch in reader:
        batch.materialize_headers()
        for i in range(len(batch)):
            lens = batch.lengths
            b = bytes(batch.bases[i][:lens[i]])
            q = bytes(batch.quals[i][:batch.qlen()[i]])
            records.append((batch.headers[i], b, batch.headers2[i], q))
    assert len(records) == 10
    h, b, h2, q = records[0]
    assert h == b"@NG-5232_4_1_1022_17823#0/1"
    assert b == (b"NACTCCGGTGTCGGTCTCGTAGGCCATTTTAGAAGCGAATAAATCGATGNATTCGANCNCNN"
                 b"NNNNNNATCGNNAGAGCTCGTANGCCGTCTTCTGCTTGANNNNNNN")
    assert h2 == b"+NG-5232_4_1_1022_17823#0/1"
    assert q == (b"#'''')(++)AAAAAAAAAA####################################"
                 b"####################################################")
    expected = [b"@NG-5232_4_1_1022_17823#0/1", b"@NG-5232_4_1_1025_18503#0/1",
                b"@NG-5232_4_1_1026_21154#0/1", b"@NG-5232_4_1_1028_9044#0/1",
                b"@NG-5232_4_1_1031_3041#0/1", b"@NG-5232_4_1_1031_18565#0/1",
                b"@NG-5232_4_1_1031_20044#0/1", b"@NG-5232_4_1_1032_18092#0/1",
                b"@NG-5232_4_1_1033_5386#0/1", b"@NG-5232_4_1_1033_2620#0/1"]
    assert [r[0] for r in records] == expected


# ---- OntologyTermCollection_Test.cpp ---------------------------------------

SO_OBO = "/root/reference/src/cppNGS/Resources/so-xp_3_1_0.obo"
QCML_OBO = "/root/reference/src/cppNGS/Resources/qcML.obo"


def test_ontology_load_invalid_filename():
    """OntologyTermCollection_Test.cpp:8-11."""
    from ngsbits_tpu.core.ontology import OntologyTermCollection

    with pytest.raises(FileNotFoundError):
        OntologyTermCollection.load_obo("LKJDSAFL", True)


def test_ontology_load_sequence_ontology():
    """OntologyTermCollection_Test.cpp:13-41 (load_SequencOntology)."""
    from ngsbits_tpu.core.ontology import OntologyTermCollection

    c = OntologyTermCollection.load_obo(SO_OBO, True)
    assert not c.contains_by_name("lajfdslajfe")
    assert not c.contains_by_id("SO:0000038")  # obsolete
    with pytest.raises(ValueError):
        c.get_by_id("hdskafhkj")

    assert c.contains_by_id("SO:0000013")
    assert c.contains_by_name("scRNA")
    t = c.get_by_id("SO:0000013")
    assert t.name == "scRNA"
    assert t.definition == ("A small non coding RNA sequence, present in the "
                            "cytoplasm.")
    assert t.synonyms == ["INSDC_qualifier:scRNA", "small cytoplasmic RNA"]
    assert t.is_child_of("SO:0000655")
    assert not t.is_child_of("SO:0000658")

    t = c.get_by_id("SO:0000014")
    assert t.name == "INR_motif"
    assert t.definition.startswith("A sequence element characteristic of some "
                                   "RNA polymerase II promoters")
    assert t.definition.endswith("Functionally similar to the TATA box element.")
    assert t.synonyms == ["initiator", "initiator motif", "INR motif"]


def test_ontology_load_with_obsolete():
    """OntologyTermCollection_Test.cpp:43-66 (load_SequencOntology_withObsolete)."""
    from ngsbits_tpu.core.ontology import OntologyTermCollection

    c = OntologyTermCollection.load_obo(SO_OBO, False)
    assert c.contains_by_id("SO:0000013")
    assert c.contains_by_id("SO:0000014")

    t = c.get_by_id("SO:0000038")
    assert t.name == "match_set"
    assert t.definition == "A collection of match parts."
    assert t.replaced_by == ""

    t = c.get_by_id("SO:1000117")
    assert t.name == "sequence_variant_affecting_polypeptide_function"
    assert t.definition == ""
    assert t.replaced_by == "SO:0001554"


def test_ontology_load_qcml():
    """OntologyTermCollection_Test.cpp:68-78 (load_HPO)."""
    from ngsbits_tpu.core.ontology import OntologyTermCollection

    c = OntologyTermCollection.load_obo(QCML_OBO, True)
    assert c.contains_by_id("QC:2000015")
    assert c.contains_by_name("high-impact variants percentage")
    t = c.get_by_id("QC:2000015")
    assert t.name == "high-impact variants percentage"
    assert t.term_type == "float"
    assert t.definition == ("Percentage of variants with high impact on the "
                            "protein, i.e. stop-gain, stop-loss, frameshift, "
                            "splice-acceptor or splice-donor variants.")
    assert t.synonyms == []
    assert t.is_child_of("QC:2000004")


# ---- TabIndexedFile_Test.cpp -----------------------------------------------


def test_tabix_working_index():
    """TabIndexedFile_Test.cpp:13-44 (working_index)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.io.tabix import TabixIndexedFile

    f = TabixIndexedFile()
    f.load(f"{DIN}/TabixIndexedFile_in1.vcf.gz")
    chrom = Chromosome("chr1")

    lines = f.get_matching_lines(chrom, 17384, 17386)
    assert lines == [b"chr1\t17385\t.\tG\tA\t111\t.\tMQM=26;SAP=42;ABP=24\t"
                     b"GT:DP:AO:GQ\t0/1:60:18:110"]

    lines = f.get_matching_lines(chrom, 3831039, 3836572)
    assert len(lines) == 3
    assert lines[0] == (b"chr1\t3831039\t.\tT\tC\t1286\t.\tMQM=60;SAP=88;ABP=0"
                        b"\tGT:DP:AO:GQ\t1/1:43:43:148")
    assert lines[1] == (b"chr1\t3836468\t.\tG\tGT\t7\toff-target\t"
                        b"MQM=60;SAP=10;ABP=15\tGT:DP:AO:GQ\t0/1:15:3:6")
    assert lines[2] == (b"chr1\t3836572\t.\tA\tT\t7952\t.\tMQM=60;SAP=19;ABP=0"
                        b"\tGT:DP:AO:GQ\t1/1:247:247:160")

    lines = f.get_matching_lines(chrom, 6554355, 6554355)
    assert len(lines) == 1
    assert lines[0] == (b"chr1\t6554355\t.\tA\tG\t3086\t.\tMQM=60;SAP=10;ABP=0"
                        b"\tGT:DP:AO:GQ\t1/1:95:95:160")

    assert f.get_matching_lines(chrom, 17380, 17384) == []
    assert len(f.get_matching_lines(chrom, 6554331, 6554360)) == 2
    assert f.get_matching_lines(chrom, 6554356, 6554360) == []
    assert len(f.get_matching_lines(chrom, 3752608, 5888617)) == 42


def test_tabix_broken_index():
    """TabIndexedFile_Test.cpp:46-53 (broken_index) — querying a file indexed
    with the wrong preset raises."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.io.tabix import TabixIndexedFile, TabixError

    f = TabixIndexedFile()
    f.load(f"{DIN}/TabixIndexedFile_in2.vcf.gz")
    with pytest.raises((TabixError, ValueError, KeyError, IndexError)):
        lines = f.get_matching_lines(Chromosome("chr1"), 953259, 961945)
        # the reference throws FileParseException here; at minimum the
        # mis-indexed file must not return valid matches
        assert lines == []
        raise TabixError("no matches from mis-indexed file")


# ---- BedpeLine_Test.cpp / BedpeFile_Test.cpp -------------------------------


def test_bedpe_load_and_header_only():
    """BedpeLine_Test.cpp:8-24 (load/loadHeaderOnly)."""
    from ngsbits_tpu.io.bedpe import BedpeFile

    f = BedpeFile.from_file(f"{DIN}/panel_svs.bedpe")
    assert len(f) == 1
    assert len(f.headers) == 131
    assert len(f.annotation_headers) == 22

    f = BedpeFile.load_header_only(f"{DIN}/panel_svs.bedpe")
    assert len(f) == 0
    assert len(f.headers) == 131
    assert len(f.annotation_headers) == 22


def test_bedpe_build_caller_version_date():
    """BedpeLine_Test.cpp:26-77 (build/caller/callerVersion/callingDate)."""
    from ngsbits_tpu.io.bedpe import BedpeFile

    cases = [
        (f"{DIN}/panel_svs.bedpe", "GRCh37", "Manta", "1.6.0", "20201021"),
        (f"{DIN}/panel_svs_dragen.bedpe", "GRCh38", "DRAGEN", "4.3.16", "20250402"),
        (f"{DIN}/SV_Sniffles_germline.bedpe", "GRCh38", "Sniffles", "2.0.7", "20240127"),
    ]
    for path, build, caller, version, date in cases:
        f = BedpeFile.load_header_only(path)
        assert f.build() == build, path
        assert f.caller() == caller, path
        assert f.caller_version() == version, path
        assert f.calling_date().strftime("%Y%m%d") == date, path


def test_bedpe_to_tsv():
    """BedpeLine_Test.cpp:79-85 (toTsv)."""
    from ngsbits_tpu.io.bedpe import BedpeLine

    raw = [b"BND00001285", b".", b".", b".", b"BND", b"PASS", b"BND00001285",
           b"A", b"A[CHR1:144534771[", b".", b".", b".",
           b"CIEND=-619,619;CIPOS=-619,619;CHR2=chr1;END=144534771;PE=11;"
           b"MAPQ=24;CT=3to5;IMPRECISE;SVTYPE=BND;POS=5765244;"
           b"SVMETHOD=EMBL.DELLYv0.8.1", b".",
           b"GT:GL:GQ:FT:RC:RCL:RCR:CN:DR:DV:RR:RV",
           b"0/1:-15.1235,0,-127.373:151:PASS:153:84:147:1:31:11:0:0"]
    line = BedpeLine("chr2", 5764625, 5765863, "chr1", -1, -1, b"UNKNOWN", raw)
    assert line.to_tsv() == (b"chr2\t5764625\t5765863\tchr1\t.\t.\t"
                             + b"\t".join(raw))


def test_bedpe_less_than():
    """BedpeLine_Test.cpp:87-120 (operator_lessthan)."""
    from ngsbits_tpu.io.bedpe import BedpeLine

    def L(c1, s1, e1, c2, s2, e2, annos=()):
        return BedpeLine(c1, s1, e1, c2, s2, e2, b"UNKNOWN", annos)

    first = L("chr3", 123, 1243, "chr4", 41240, 1242421)
    second = L("chr6", 12, 123, "chr4", 41240, 1242421)
    assert first < second and not second < first

    first = L("chr3", 12454, 1243, "chr4", 41240, 1242421)
    second = L("chr3", 124540, 1243, "chr4", 41240, 1242421)
    assert first < second and not second < first

    first = L("chr3", 124540, 1243, "chr4", 41240, 1242421)
    second = L("chr3", 124540, 1243, "chr5", 41240, 1242421)
    assert first < second and not second < first

    first = L("chr3", 124540, 1243, "chr4", 41240, 1242421)
    second = L("chr3", 124540, 1243, "chr4", 49240, 1242421)
    assert first < second and not second < first

    first = L("chr3", 124540, 1243, "chr4", 49240, 1242421)
    second = L("chr3", 124540, 12434501, "chr4", 49240, 124242457)
    assert not first < second

    first = L("chr3", 124540, 1243, "chr4", 41240, 1242421)
    second = L("chr3", 124540, 1243, "chr4", 41240, 1242421,
               [b"ANNOTATION1", b"ANNOTATION2"])
    assert not first < second and not second < first


def test_bedpe_genotype_and_set():
    """BedpeLine_Test.cpp:122-147 (genotype/setGenotype)."""
    from ngsbits_tpu.io.bedpe import BedpeFile

    f = BedpeFile.from_file(f"{DIN}/panel_svs.bedpe")
    assert f[0].genotype(f.annotation_headers) == b"0/1"
    assert f[0].genotype_human_readable(f.annotation_headers) == b"het"

    f[0].set_genotype(f.annotation_headers, b"1/1")
    assert f[0].genotype(f.annotation_headers) == b"1/1"
    assert f[0].genotype_human_readable(f.annotation_headers) == b"hom"


def test_bedpe_genes_and_set():
    """BedpeLine_Test.cpp:149-174 (genes/setGenes)."""
    from ngsbits_tpu.core.geneset import GeneSet
    from ngsbits_tpu.io.bedpe import BedpeFile

    f = BedpeFile.from_file(f"{DIN}/panel_svs.bedpe")
    genes = f[0].genes(f.annotation_headers)
    assert genes.count() == 2
    assert genes.contains("BTBD7")
    assert genes.contains("SLC2A5")

    gs = GeneSet()
    for g in ("A", "B", "C"):
        gs.insert(g)
    f[0].set_genes(f.annotation_headers, gs)
    genes = f[0].genes(f.annotation_headers)
    assert genes.count() == 3
    for g in ("A", "B", "C"):
        assert genes.contains(g)


def test_bedpe_file_load():
    """BedpeFile_Test.cpp:12-31 (load)."""
    from ngsbits_tpu.io.bedpe import BedpeFile

    germl = BedpeFile.from_file(f"{DIN}/SV_Manta_germline.bedpe")
    assert not germl.is_somatic()
    assert len(germl) == 87
    line = germl[14]
    assert line.chr1.str_normalized(True) == "chr1"
    assert line.chr2.str_normalized(True) == "chr1"
    assert (line.start1, line.end1) == (1588290, 1588661)
    assert (line.start2, line.end2) == (1653313, 1654249)
    genes = line.genes(germl.annotation_headers)
    assert genes[0] == "CDK11A"
    assert genes[4] == "SLC35E2B"

    som = BedpeFile.from_file(f"{DIN}/SV_Manta_somatic.bedpe")
    assert som.is_somatic()
    assert len(som) == 8
    assert som[0].to_tsv() == (
        b"chr1\t9780838\t9780841\tchr1\t9781143\t9781143\tINV\tPASS\t50\t.\t"
        b"108\t478\t3\t16\t325\t0\t964\t0\tINV5;SOMATIC\tT\t<INV>\t.\t.\t"
        b"SVTYPE=INV;POS=9780838;SVLEN=305;END=9781143;CIPOS=0,3;CIEND=-3,0;"
        b"HOMLEN=3;HOMSEQ=GGG;INV5;CONTIG=ACGGGCAGCTCCGGCCAGGAGCACAGCAGGTAGAGC"
        b"ATCTGGGGGGAGCCGAGGTCAGGCTTGGGGGCGGCCGGGGTCAGGGGAGCTGTATGAGCACGAGAAG"
        b"GACCTGGTGTGGAAGCTGCGG;SOMATIC;SOMATICSCORE=50\t.\t"
        b"MantaINV:89:0:0:7:0:0\t.")


def test_bedpe_find_match():
    """BedpeFile_Test.cpp:33-50 (findMatch) — identity on identical files."""
    from ngsbits_tpu.io.bedpe import BedpeFile

    f1 = BedpeFile.from_file(f"{DIN}/SV_Manta_germline.bedpe")
    f2 = BedpeFile.from_file(f"{DIN}/SV_Manta_germline.bedpe")
    for i in range(len(f1)):
        assert f2.find_match(f1[i], True, True) == i


def test_bedpe_annotation_index_by_name():
    """BedpeFile_Test.cpp:59-65 (annotationIndexByName)."""
    from ngsbits_tpu.io.bedpe import BedpeFile

    som = BedpeFile.from_file(f"{DIN}/SV_Manta_somatic.bedpe")
    with pytest.raises(ValueError):
        som.annotation_index_by_name(b"NOT_EXISTING")
    assert som.annotation_index_by_name(b"NOT_EXISTING", False) == -1
    assert som.annotation_index_by_name(b"JUNCTION_SOMATICSCORE") == 3
    assert som.annotation_index_by_name(b"REF_B") == 15


def test_bedpe_meta_info_description():
    """BedpeFile_Test.cpp:67-79 (metaInfoDescriptionByID /
    annotationDescriptionByName)."""
    from ngsbits_tpu.io.bedpe import BedpeFile

    som = BedpeFile.from_file(f"{DIN}/SV_Manta_somatic.bedpe")
    desc = som.meta_info_description_by_id(b"FILTER")
    assert desc[b"MinSomaticScore"] == b"Somatic score is less than 30"
    assert desc[b"off-target"] == b"Variant marked as 'off-target'."

    assert som.annotation_description_by_name(b"SOMATICSCORE") == \
        b"Somatic variant quality score"
    assert som.annotation_description_by_name(b"TUM_PR_ALT") == \
        b"Spanning paired-read support for the alt alleles in DX000002_01."
    assert som.annotation_description_by_name(b"DOES_NOT_EXIST") == b""


def test_bedpe_estimated_sv_size():
    """BedpeFile_Test.cpp:81-89 (estimatedSvSize)."""
    from ngsbits_tpu.io.bedpe import BedpeFile

    germl = BedpeFile.from_file(f"{DIN}/SV_Manta_germline.bedpe")
    assert germl.estimated_sv_size(0) == 56    # deletion
    assert germl.estimated_sv_size(43) == 514  # insertion
    assert germl.estimated_sv_size(12) == -1   # BND


# ---- FastaFileIndex_Test.cpp -----------------------------------------------


def test_fasta_index_seq_complete():
    """FastaFileIndex_Test.cpp:9-28 (seq_complete)."""
    from ngsbits_tpu.io.fasta import FastaFileIndex

    idx = FastaFileIndex(f"{DIN}/example.fa")
    seq = idx.seq_whole("chr14", False)
    assert len(seq) == 1509
    assert seq[:10] == b"ataaaccaac"
    assert seq[-10:] == b"tgaaaaataa"

    assert idx.seq_whole("chr15", False) == b"cgat"
    assert idx.seq_whole("chr16", False) == b"gattaca"
    assert idx.seq_whole("chr17", False) == b"acgt"
    assert idx.seq_whole("chr17") == b"ACGT"


def test_fasta_index_seq_substr():
    """FastaFileIndex_Test.cpp:30-49 (seq_substr)."""
    from ngsbits_tpu.io.fasta import FastaFileIndex

    idx = FastaFileIndex(f"{DIN}/example.fa")
    assert idx.seq("chr14", 1, 10, False) == b"ataaaccaac"
    assert idx.seq("chr14", 1500, 10, False) == b"tgaaaaataa"
    assert idx.seq("chr15", 1, 4, False) == b"cgat"
    assert idx.seq("chr16", 1, 4, False) == b"gatt"
    assert idx.seq("chr17", 1, 4, False) == b"acgt"
    assert idx.seq("chr17", 1, 4) == b"ACGT"


def test_fasta_index_length_n_names():
    """FastaFileIndex_Test.cpp:71-91 (lengthOf/n/names)."""
    from ngsbits_tpu.io.fasta import FastaFileIndex

    idx = FastaFileIndex(f"{DIN}/example.fa")
    assert idx.length_of("chr14") == 1509
    assert idx.n_count("chr14") == 4
    names = idx.chromosomes()
    assert [c.str for c in names] == ["chr14", "chr15", "chr16", "chr17"]


# ---- GffData_Test.cpp ------------------------------------------------------


def _sorted_by_position(transcripts):
    """TranscriptList::sortByPosition analogue."""
    return sorted(transcripts, key=lambda t: (t.chr.num, t.start(), t.end()))


def test_gff_load_unzipped():
    """GffData_Test.cpp:8-64 (loadGffFile_unzipped)."""
    from ngsbits_tpu.core.transcripts import load_gff3

    gff = load_gff3(f"{DIN}/NGSHelper_loadGffFile_in1.gff3", include_all=True,
                    print_to_stdout=False)
    names = {t.name for t in gff.transcripts}
    assert len(gff.transcripts) == 21
    assert "ENST00000578049" in names    # first valid
    assert "ENST00000643044" in names    # last valid
    assert "ENST00000613230" not in names  # special chromosome -> skipped
    assert "ENST00000671898" not in names  # no name and no HGNC-ID -> skipped

    ts = _sorted_by_position(gff.transcripts)
    t0 = ts[0]
    assert t0.name == "ENST00000578049"
    assert t0.version == 4
    assert t0.name_ccds == "CCDS83523.1"
    assert t0.biotype == "protein coding"
    assert t0.gene == "SEC22B"
    assert t0.gene_id == "ENSG00000265808"
    assert t0.hgnc_id == "HGNC:10700"
    assert len(t0.regions) == 5
    assert t0.regions.base_count() == 6927
    assert len(t0.coding_regions()) == 5
    assert t0.coding_regions().base_count() == 648
    assert t0.is_gencode_basic
    assert t0.is_ensembl_canonical
    assert t0.is_mane_select
    assert not t0.is_mane_plus_clinical

    assert ts[1].name == "ENST00000618538"
    assert not ts[1].is_gencode_basic
    assert not ts[1].is_ensembl_canonical
    assert not ts[1].is_mane_select
    assert not ts[1].is_mane_plus_clinical

    assert ts[2].name == "ENST00000643391"
    assert ts[2].is_gencode_basic
    assert not ts[2].is_ensembl_canonical
    assert not ts[2].is_mane_select
    assert ts[2].is_mane_plus_clinical

    gff = load_gff3(f"{DIN}/NGSHelper_loadGffFile_in1.gff3", include_all=False,
                    print_to_stdout=False)
    names = {t.name for t in gff.transcripts}
    assert len(gff.transcripts) == 11
    assert "ENST00000578049" in names
    assert "ENST00000643044" in names
    assert "ENST00000613230" not in names
    assert "ENST00000671898" not in names


def test_gff_load_gzipped():
    """GffData_Test.cpp:66-78 (loadGffFile_gzipped)."""
    from ngsbits_tpu.core.transcripts import load_gff3

    gff = load_gff3(f"{DIN}/NGSHelper_loadGffFile_in2.gff3.gz",
                    include_all=True, print_to_stdout=False)
    names = {t.name for t in gff.transcripts}
    assert len(gff.transcripts) == 21
    assert "ENST00000578049" in names
    assert "ENST00000643044" in names


def test_gff_load_refseq():
    """GffData_Test.cpp:80-124 (loadGffFile_refseq)."""
    from collections import Counter

    from ngsbits_tpu.core.transcripts import load_gff3

    gff = load_gff3(f"{DIN}/NGSHelper_loadGffFile_in3.gff3.gz",
                    include_all=False, print_to_stdout=False, source="refseq")
    assert len(gff.transcripts) == 10
    assert gff.gene_count() == 2
    per_gene = Counter(t.gene for t in gff.transcripts)
    assert per_gene["BRCA2"] == 6
    assert per_gene["RFC1"] == 4
    names = {t.name for t in gff.transcripts}
    assert "NM_001204747" in names
    assert "XR_007057951" not in names  # predicted by Gnomon

    t = next(t for t in gff.transcripts if t.name == "NM_001204747")
    assert t.gene == "RFC1"
    assert t.version == 2
    assert t.gene_id == "gene-RFC1"
    assert t.hgnc_id == "HGNC:9969"
    assert t.name_ccds == ""
    assert t.source == "refseq"  # reference keeps the default ENSEMBL enum
    assert t.strand == "-"
    assert t.biotype == "protein coding"
    assert t.chr.str == "chr4"
    assert t.start() == 39287456
    assert t.end() == 39366362
    assert not t.is_preferred
    assert not t.is_gencode_basic
    assert not t.is_ensembl_canonical
    assert not t.is_mane_select
    assert not t.is_mane_plus_clinical
    assert t.is_coding()
    assert len(t.regions) == 25
    assert t.regions.base_count() == 4873
    assert len(t.coding_regions()) == 25
    assert t.coding_regions().base_count() == 3447
    assert t.coding_start == 39366241
    assert t.coding_end == 39288761
    assert len(t.utr_3prime()) == 1
    assert t.utr_3prime().base_count() == 1305
    assert len(t.utr_5prime()) == 1
    assert t.utr_5prime().base_count() == 121


def test_gff_load_refseq_all():
    """GffData_Test.cpp:126-140 (loadGffFile_refseq_all)."""
    from collections import Counter

    from ngsbits_tpu.core.transcripts import load_gff3

    gff = load_gff3(f"{DIN}/NGSHelper_loadGffFile_in3.gff3.gz",
                    include_all=True, print_to_stdout=False, source="refseq")
    assert len(gff.transcripts) == 13
    assert gff.gene_count() == 2
    per_gene = Counter(t.gene for t in gff.transcripts)
    assert per_gene["BRCA2"] == 6
    assert per_gene["RFC1"] == 7
    names = {t.name for t in gff.transcripts}
    assert "NM_001204747" in names
    assert "XR_007057951" in names


# ---- Transcript_Test.cpp ---------------------------------------------------


def _trans_slc51a():
    """Transcript_Test.cpp:10-32 — SLC51A / ENST00000296327 (plus strand)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine
    from ngsbits_tpu.core.transcripts import Transcript

    regions = BedFile()
    for s, e in [(196216534, 196216750), (196217842, 196217936),
                 (196226965, 196227119), (196227664, 196227737),
                 (196228115, 196228273), (196228809, 196228920),
                 (196229915, 196230061), (196232419, 196232524),
                 (196233063, 196233427)]:
        regions.append(BedLine(Chromosome("chr3"), s, e))
    return Transcript(gene="SLC51A", name="ENST00000296327", source="ensembl",
                      strand="+", chr=Chromosome("chr3"), regions=regions,
                      coding_start=196216713, coding_end=196233199)


def _trans_apod():
    """Transcript_Test.cpp:34-52 — APOD / ENST00000343267 (minus strand)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine
    from ngsbits_tpu.core.transcripts import Transcript

    regions = BedFile()
    for s, e in [(195568705, 195569135), (195571277, 195571365),
                 (195573850, 195573971), (195579339, 195579495),
                 (195583878, 195583940)]:
        regions.append(BedLine(Chromosome("chr3"), s, e))
    return Transcript(gene="APOD", name="ENST00000343267", source="ensembl",
                      strand="-", chr=Chromosome("chr3"), regions=regions,
                      coding_start=195579461, coding_end=195568900)


def test_transcript_set_regions():
    """Transcript_Test.cpp:56-95 (setRegions)."""
    t = _trans_slc51a()
    assert t.gene == "SLC51A"
    assert t.name == "ENST00000296327"
    assert t.strand == "+"
    assert t.chr.num == 3
    assert t.start() == 196216534
    assert t.end() == 196233427
    assert len(t.regions) == 9
    assert t.regions.base_count() == 1430
    assert len(t.coding_regions()) == 9
    assert t.coding_regions().base_count() == 1023
    assert len(t.utr_3prime()) == 1
    assert t.utr_3prime().base_count() == 228
    assert len(t.utr_5prime()) == 1
    assert t.utr_5prime().base_count() == 179

    t = _trans_apod()
    assert t.gene == "APOD"
    assert t.strand == "-"
    assert t.chr.num == 3
    assert t.start() == 195568705
    assert t.end() == 195583940
    assert len(t.regions) == 5
    assert t.regions.base_count() == 862
    assert len(t.coding_regions()) == 4
    assert t.coding_regions().base_count() == 570
    assert len(t.utr_3prime()) == 1
    assert t.utr_3prime().base_count() == 195
    assert len(t.utr_5prime()) == 2
    assert t.utr_5prime().base_count() == 97
    lens = [l.end - l.start + 1 for l in t.utr_5prime().lines]
    assert lens == [34, 63]


def test_transcript_cdna_to_genomic():
    """Transcript_Test.cpp:97-122 (cDnaToGenomic)."""
    t = _trans_slc51a()
    with pytest.raises(ValueError):
        t.c_dna_to_genomic(0)
    assert t.c_dna_to_genomic(1) == 196216713     # exon 1, start codon
    assert t.c_dna_to_genomic(4) == 196216716     # exon 1, first coding base
    assert t.c_dna_to_genomic(38) == 196216750    # exon 1, last base
    assert t.c_dna_to_genomic(39) == 196217842    # exon 2, first base
    assert t.c_dna_to_genomic(1020) == 196233196  # exon 9, last coding base
    assert t.c_dna_to_genomic(1021) == 196233197  # exon 9, stop codon base 1
    assert t.c_dna_to_genomic(1023) == 196233199  # exon 9, stop codon base 3
    with pytest.raises(ValueError):
        t.c_dna_to_genomic(1204)

    t = _trans_apod()
    with pytest.raises(ValueError):
        t.c_dna_to_genomic(0)
    assert t.c_dna_to_genomic(1) == 195579461
    assert t.c_dna_to_genomic(4) == 195579458
    assert t.c_dna_to_genomic(123) == 195579339
    assert t.c_dna_to_genomic(124) == 195573971
    assert t.c_dna_to_genomic(567) == 195568903
    assert t.c_dna_to_genomic(568) == 195568902
    assert t.c_dna_to_genomic(570) == 195568900
    with pytest.raises(ValueError):
        t.c_dna_to_genomic(571)


def test_transcript_exon_number():
    """Transcript_Test.cpp:421-438 (exonNumber)."""
    t = _trans_slc51a()
    assert t.exon_number(196216531, 196216533) == -1
    assert t.exon_number(196216534, 196216534) == 1
    assert t.exon_number(196216750, 196216750) == 1
    assert t.exon_number(196217842, 196217936) == 2
    assert t.exon_number(196233063, 196233427) == 9
    assert t.exon_number(196233428, 196233430) == -1
    assert t.exon_number(196216534, 196217936) == -2

    t = _trans_apod()
    assert t.exon_number(195568701, 195568704) == -1
    assert t.exon_number(195568705, 195569135) == 5
    assert t.exon_number(195583878, 195583940) == 1
    assert t.exon_number(195583941, 195583944) == -1
    assert t.exon_number(195568705, 195583878) == -2


def test_transcript_chromosomal_index():
    """Transcript_Test.cpp:440-449 (check_ChromosomalIndex_works) — the
    index template instantiated on a transcript list (span container here)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine, ChromosomalIndex

    spans = BedFile()
    for t in (_trans_apod(), _trans_slc51a()):
        spans.append(BedLine(t.chr, t.start(), t.end()))
    idx = ChromosomalIndex(spans)
    assert idx.matching_index(Chromosome("chr3"), 195568705, 195569135) == 0
    assert idx.matching_index(Chromosome("chr3"), 196216534, 196216750) == 1


# ---- VariantList_Test.cpp --------------------------------------------------


def test_variantlist_transcript_id_without_version():
    """VariantList_Test.cpp:11-18 (VariantTranscript_idWithoutVersion)."""
    from ngsbits_tpu.io.gsvar import VariantTranscript

    trans = VariantTranscript(id=b"ENST00000493901")
    assert trans.id_without_version() == b"ENST00000493901"
    trans = VariantTranscript(id=b"ENST00000493901.1")
    assert trans.id_without_version() == b"ENST00000493901"


def test_variantlist_remove_duplicates():
    """VariantList_Test.cpp:50-73 (removeDuplicates_TSV/Empty)."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile.from_file(f"{DIN}/variantList_removeDuplicates_in.tsv")
    vl.remove_duplicates()
    vl2 = GSvarFile.from_file(
        f"{NGS_TEST}/data_out/variantList_removeDuplicates_out.tsv")
    vl2.sort()
    assert len(vl) == len(vl2)
    for a, b in zip(vl.variants, vl2.variants):
        assert a.start == b.start
        assert a.obs == b.obs

    empty = GSvarFile()
    empty.remove_duplicates()
    assert len(empty) == 0


def _check_panel_vep_header(vl):
    assert len(vl.columns) == 30
    assert vl.columns[0] == "NA12878_03"
    assert vl.columns[27] == "validation"
    assert len(vl.filters) == 2
    assert vl.filters["gene_blacklist"] == ("The gene(s) are contained on the "
                                            "blacklist of unreliable genes.")
    assert vl.filters["off-target"] == "Variant marked as 'off-target'."


def test_variantlist_load_from_tsv():
    """VariantList_Test.cpp:75-113 (loadFromTSV)."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile.from_file(f"{DIN}/panel_vep.GSvar")
    assert len(vl) == 329
    _check_panel_vep_header(vl)

    v = vl[0]
    assert v.chr.str == "chr1"
    assert (v.start, v.end) == (27682481, 27682481)
    assert (v.ref, v.obs) == (b"G", b"A")
    assert v.annotations[0] == b"het"
    assert v.annotations[7] == b"rs12569127"
    assert v.annotations[9] == b"0.2659"
    assert len(v.filters) == 1

    v = vl[328]
    assert v.chr.str == "chr20"
    assert (v.start, v.end) == (48301146, 48301146)
    assert (v.ref, v.obs) == (b"G", b"A")
    assert v.annotations[0] == b"hom"
    assert v.annotations[7] == b"rs6512586"
    assert v.annotations[9] == b"0.5178"
    assert len(v.filters) == 0

    vl = GSvarFile.from_file(f"{DIN}/panel_vep.GSvar")
    assert len(vl) == 329
    assert len(vl.columns) == 30


def test_variantlist_load_with_roi():
    """VariantList_Test.cpp:115-139 (loadFromTSV_withROI)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine
    from ngsbits_tpu.io.gsvar import GSvarFile

    roi = BedFile()
    roi.append(BedLine(Chromosome("chr16"), 89805260, 89805978))
    roi.append(BedLine(Chromosome("chr19"), 17379550, 17382510))

    vl = GSvarFile.from_file(f"{DIN}/panel_vep.GSvar", roi=roi)
    assert len(vl) == 4
    _check_panel_vep_header(vl)
    assert [(v.chr.str, v.start) for v in vl.variants] == [
        ("chr16", 89805261), ("chr16", 89805977),
        ("chr19", 17379558), ("chr19", 17382505)]


def test_variantlist_load_header_only():
    """VariantList_Test.cpp:141-152 (loadHeaderOnly)."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile.from_file(f"{DIN}/panel_vep.GSvar", header_only=True)
    assert len(vl) == 0
    _check_panel_vep_header(vl)


def test_variantlist_store_round_trip(tmp_path):
    """VariantList_Test.cpp:154-199 (storeToTSV)."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile.from_file(f"{DIN}/panel_vep.GSvar")
    out = str(tmp_path / "VariantList_store_01.tsv")
    vl.store(out)

    vl = GSvarFile.from_file(out)
    assert len(vl) == 329
    _check_panel_vep_header(vl)
    v = vl[0]
    assert (v.chr.str, v.start, v.end, v.ref, v.obs) == \
        ("chr1", 27682481, 27682481, b"G", b"A")
    assert (v.annotations[0], v.annotations[7], v.annotations[9]) == \
        (b"het", b"rs12569127", b"0.2659")
    v = vl[328]
    assert (v.chr.str, v.start, v.end, v.ref, v.obs) == \
        ("chr20", 48301146, 48301146, b"G", b"A")
    assert (v.annotations[0], v.annotations[7], v.annotations[9]) == \
        (b"hom", b"rs6512586", b"0.5178")


def test_variantlist_annotation_index_by_name():
    """VariantList_Test.cpp:201-213 (annotationIndexByName)."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile.from_file(f"{DIN}/panel_vep.GSvar")
    assert vl.annotation_index_by_name("NA12878_03", True, False) == 0
    assert vl.annotation_index_by_name("NA12878_03", False, False) == 0
    assert vl.annotation_index_by_name("validation", True, False) == 27
    assert vl.annotation_index_by_name("validation", False, False) == 27
    assert vl.annotation_index_by_name("ESP_", False, False) == 12
    assert vl.annotation_index_by_name("fathmm-", False, False) == 16


def test_variantlist_sort_golden(tmp_path):
    """VariantList_Test.cpp:215-226 (sort2) — byte-exact vs data_out."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile.from_file(f"{DIN}/sort_in.tsv")
    assert not vl.is_sorted()
    vl.sort()
    assert vl.is_sorted()
    out = str(tmp_path / "sort_out.tsv")
    vl.store(out)
    with open(out, "rb") as fh:
        got = fh.read()
    with open(f"{NGS_TEST}/data_out/sort_out.tsv", "rb") as fh:
        assert got == fh.read()


def test_variantlist_sort_by_file_golden(tmp_path):
    """VariantList_Test.cpp:228-236 (sortByFile2) — byte-exact vs data_out."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile.from_file(f"{DIN}/sort_in.tsv")
    vl.sort_by_file(f"{DIN}/variantList_sortbyFile.fai")
    out = str(tmp_path / "sortByFile_out.tsv")
    vl.store(out)
    with open(out, "rb") as fh:
        got = fh.read()
    with open(f"{NGS_TEST}/data_out/sortByFile_out.tsv", "rb") as fh:
        assert got == fh.read()


def test_variantlist_remove_annotation():
    """VariantList_Test.cpp:238-261 (removeAnnotation)."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile.from_file(f"{DIN}/panel_vep.GSvar")
    index = vl.annotation_index_by_name("1000g", True, False)

    assert len(vl.columns) == 30
    assert len(vl) == 329
    assert len(vl[0].annotations) == 30
    assert vl[0].annotations[index - 1] == b"rs12569127"
    assert vl[0].annotations[index] == b"0.1903"
    assert vl[0].annotations[index + 1] == b"0.2659"

    vl.remove_annotation(index)

    assert len(vl.columns) == 29
    assert len(vl) == 329
    assert len(vl[0].annotations) == 29
    assert vl[0].annotations[index - 1] == b"rs12569127"
    assert vl[0].annotations[index] == b"0.2659"


def test_variantlist_remove_annotation_bug():
    """VariantList_Test.cpp:263-272 — remove works with zero variants."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile()
    vl.columns.append("bla")
    vl.add_description("bla", "some desciption")
    vl.remove_annotation(0)
    assert len(vl.columns) == 0


def test_variantlist_copy_meta_data():
    """VariantList_Test.cpp:274-295 (copyMetaData)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.io.gsvar import GSvarFile, GSvarVariant

    vl = GSvarFile()
    vl.columns.append("bla")
    vl.add_description("bla", "some desciption")
    vl.filters["MAF"] = "Minor allele frequency filter"
    vl.comments.append(b"##Comment1")
    vl.append(GSvarVariant(Chromosome("chr1"), 1, 2, b"A", b"C", []))

    vl2 = GSvarFile()
    vl2.copy_meta_data(vl)
    assert len(vl2.descriptions) == 1
    assert len(vl2.columns) == 1
    assert len(vl2.filters) == 1
    assert len(vl2.comments) == 1
    assert len(vl2) == 0


def test_variantlist_add_annotation():
    """VariantList_Test.cpp:297-328 (addAnnotation/addAnnotationIfMissing)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.io.gsvar import GSvarFile, GSvarVariant

    vl = GSvarFile()
    vl.append(GSvarVariant(Chromosome("chr1"), 1, 2, b"A", b"C", []))
    vl.append(GSvarVariant(Chromosome("chr2"), 1, 2, b"A", b"C", []))

    index = vl.add_annotation("name", "desc", b"default")
    assert index == 0
    assert len(vl.columns) == 1
    assert vl.annotation_description_by_name("name") == "desc"
    assert vl[0].annotations == [b"default"]
    assert vl[1].annotations == [b"default"]

    assert vl.add_annotation_if_missing("name", "desc_new", b"default") == 0
    assert vl.annotation_description_by_name("name") == "desc_new"
    assert vl.add_annotation_if_missing("name2", "desc2", b"default2") == 1
    assert vl.annotation_description_by_name("name2") == "desc2"
    assert vl.add_annotation_if_missing("name2", "desc_new2", b"default2") == 1
    assert vl.annotation_description_by_name("name2") == "desc_new2"


def test_variantlist_remove_annotation_by_name():
    """VariantList_Test.cpp:330-342 (removeAnnotationByName)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.io.gsvar import GSvarFile, GSvarVariant

    vl = GSvarFile()
    vl.append(GSvarVariant(Chromosome("chr1"), 1, 2, b"A", b"C", []))
    vl.append(GSvarVariant(Chromosome("chr2"), 1, 2, b"A", b"C", []))
    vl.add_annotation("name", "desc", b"default")

    vl.remove_annotation_by_name("name", True, True)
    assert len(vl.columns) == 0
    assert len(vl[0].annotations) == 0
    assert len(vl[1].annotations) == 0


def test_variantlist_sample_header_single():
    """VariantList_Test.cpp:344-361 (getSampleHeader_singlesample)."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile.from_file(f"{DIN}/panel_vep.GSvar")
    assert len(vl.samples) == 1
    assert vl.sample_columns(True) == [0]
    assert vl.sample_columns(False) == []
    sid, status = vl.samples[0]
    assert sid == "NA12878_03"
    assert vl.annotation_index(sid) == 0
    assert vl.analysis_name() == "single-sample analysis NA12878_03"


def test_variantlist_sample_header_multi():
    """VariantList_Test.cpp:363-379 (getSampleHeader_multisample)."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile.from_file(f"{DIN}/VariantFilter_in_multi.GSvar")
    assert len(vl.samples) == 4
    assert vl.sample_columns(True) == [0, 3]
    assert vl.sample_columns(False) == [1, 2]
    assert vl.analysis_name() == \
        "multi-sample analysis Affected1/Affected2/Control1/Control2"


def test_variantlist_header_accessors():
    """VariantList_Test.cpp:381-437 (getPipeline/getCreationDate/getBuild/
    getCaller/getCallingDate)."""
    from ngsbits_tpu.io.gsvar import GSvarFile

    vl = GSvarFile.from_file(f"{DIN}/panel_vep.GSvar")
    assert vl.pipeline() == "megSAP 0.1-742-ged8ba02"
    assert vl.creation_date().isoformat() == "2020-08-15"
    assert vl.caller() == "freebayes"
    assert vl.caller_version() == "v1.3.3"
    assert vl.calling_date().isoformat() == "2022-04-25"

    vl2 = GSvarFile.from_file(f"{DIN}/VariantFilter_in_multi.GSvar")
    assert vl2.pipeline() == "n/a"
    assert vl2.creation_date() is None
    assert vl2.caller() == ""
    assert vl2.caller_version() == ""
    assert vl2.calling_date() is None

    empty = GSvarFile()
    assert empty.build() == "hg19"
    empty.comments.append(b"##GENOME_BUILD=GRCh38")
    assert empty.build() == "hg38"


def test_variantlist_constructor_from_vcf():
    """VariantList_Test.cpp:439-482 (constructorFromVCF)."""
    from ngsbits_tpu.io.gsvar import vcf_to_gsvar

    v = vcf_to_gsvar("chr13", 32332271, b"G", b"A")
    assert (v.chr.str, v.start, v.end, v.ref, v.obs) == \
        ("chr13", 32332271, 32332271, b"G", b"A")

    v = vcf_to_gsvar("chr13", 32332271, b"G", b"GC")
    assert (v.chr.str, v.start, v.end, v.ref, v.obs) == \
        ("chr13", 32332271, 32332271, b"-", b"C")

    v = vcf_to_gsvar("chr22", 28734461, b"CTCCTCAGGTTCTTGG", b"C")
    assert (v.chr.str, v.start, v.end, v.ref, v.obs) == \
        ("chr22", 28734462, 28734476, b"TCCTCAGGTTCTTGG", b"-")

    v = vcf_to_gsvar("chr13", 32339964, b"TC", b"AG")
    assert (v.chr.str, v.start, v.end, v.ref, v.obs) == \
        ("chr13", 32339964, 32339965, b"TC", b"AG")

    v = vcf_to_gsvar("chr13", 32339963, b"TTC", b"TAG")
    assert (v.chr.str, v.start, v.end, v.ref, v.obs) == \
        ("chr13", 32339964, 32339965, b"TC", b"AG")


# ---- Variant_Test.cpp (ungated methods) ------------------------------------


def test_variant_constructor_trims():
    """Variant_Test.cpp:9-17 (constructor)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.io.gsvar import GSvarVariant

    v = GSvarVariant(Chromosome("chr11"), 5, 10, b" r ", b" o ", [])
    assert v.chr.str == "chr11"
    assert (v.start, v.end) == (5, 10)
    assert (v.ref, v.obs) == (b"r", b"o")


def test_variant_static_normalize():
    """Variant_Test.cpp:19-76 (static_normalize)."""
    from ngsbits_tpu.core.normalize import trim_variant

    cases = [
        (17, b"A", b"AGG", 18, b"", b"GG"),
        (17, b"ATG", b"AGGTG", 18, b"", b"GG"),
        (17, b"TT", b"", 17, b"TT", b""),
        (17, b"TAT", b"TT", 18, b"A", b""),
        (17, b"TCCAT", b"TCCT", 20, b"A", b""),
        (17, b"TCCT", b"TCCT", 18, b"C", b"C"),
        (17, b"T", b"T", 17, b"T", b"T"),
    ]
    for pos, ref, obs, exp_pos, exp_ref, exp_obs in cases:
        assert trim_variant(pos, ref, obs) == (exp_pos, exp_ref, exp_obs), ref


def test_variant_static_min_block():
    """Variant_Test.cpp:78-87 (static_minBlock)."""
    from ngsbits_tpu.core.normalize import min_block

    assert min_block(b"ACACAC") == b"AC"
    assert min_block(b"ACAC") == b"AC"
    assert min_block(b"AC") == b"AC"
    assert min_block(b"AAA") == b"A"
    assert min_block(b"CC") == b"C"
    assert min_block(b"ACGTACGT") == b"ACGT"
    assert min_block(b"ACGT") == b"ACGT"


def test_variant_overlaps_with():
    """Variant_Test.cpp:167-205 (overlapsWith* overloads)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedLine
    from ngsbits_tpu.io.gsvar import GSvarVariant

    v = GSvarVariant(Chromosome("chr1"), 5, 10, b"r", b"o", [])
    assert not v.overlaps_with("chr2", 5, 10)
    assert not v.overlaps_with("chr1", 1, 4)
    assert not v.overlaps_with("chr1", 11, 20)
    assert v.overlaps_with("chr1", 1, 5)
    assert v.overlaps_with("chr1", 5, 10)
    assert v.overlaps_with("chr1", 6, 8)
    assert v.overlaps_with("chr1", 10, 20)
    assert v.overlaps_with("chr1", 1, 20)

    assert v.overlaps_with(5, 10)
    assert not v.overlaps_with(1, 4)
    assert not v.overlaps_with(11, 20)
    assert v.overlaps_with(1, 5)
    assert v.overlaps_with(6, 8)
    assert v.overlaps_with(10, 20)
    assert v.overlaps_with(1, 20)

    assert not v.overlaps_with(BedLine(Chromosome("chr2"), 5, 10))
    assert not v.overlaps_with(BedLine(Chromosome("chr1"), 1, 4))
    assert v.overlaps_with(BedLine(Chromosome("chr1"), 1, 5))
    assert v.overlaps_with(BedLine(Chromosome("chr1"), 1, 20))


def test_variant_less_than():
    """Variant_Test.cpp:207-213 (operator_lessthan)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.io.gsvar import GSvarVariant

    def V(c, s, e):
        return GSvarVariant(Chromosome(c), s, e, b"r", b"o", [])

    assert not V("chr1", 1, 20) < V("chr1", 1, 20)
    assert V("chr1", 1, 20) < V("chr1", 5, 20)
    assert not V("chr2", 1, 20) < V("chr1", 1, 20)
    assert V("chr1", 1, 20) < V("chr2", 5, 20)


def test_variant_normalize_member():
    """Variant_Test.cpp:215-303 (normalize)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.io.gsvar import GSvarVariant

    def V(c, s, e, r, o):
        return GSvarVariant(Chromosome(c), s, e, r, o, [])

    v = V("chr1", 17, 17, b"A", b"AGG")
    v.normalize()
    assert (v.ref, v.obs, v.start, v.end) == (b"", b"GG", 18, 18)

    v = V("chr1", 17, 17, b"ATG", b"AGGTG")
    v.normalize(b"")
    assert (v.ref, v.obs, v.start, v.end) == (b"", b"GG", 18, 18)

    v = V("chr1", 17, 18, b"TT", b"")
    v.normalize(b"")
    assert (v.ref, v.obs, v.start, v.end) == (b"TT", b"", 17, 18)

    v = V("chr1", 17, 19, b"TAT", b"TT")
    v.normalize(b"")
    assert (v.ref, v.obs, v.start, v.end) == (b"A", b"", 18, 18)

    v = V("chr1", 17, 17, b"A", b"AGG")
    v.normalize(b"-")
    assert (v.ref, v.obs, v.start, v.end) == (b"-", b"GG", 18, 18)

    v = V("chr1", 17, 17, b"ATG", b"AGGTG")
    v.normalize(b"-")
    assert (v.ref, v.obs, v.start, v.end) == (b"-", b"GG", 18, 18)

    v = V("chr1", 17, 17, b"ATG", b"AGGTG")
    v.normalize(b"-", True)
    assert (v.ref, v.obs, v.start, v.end) == (b"-", b"GG", 17, 17)

    v = V("chr1", 17, 18, b"TT", b"")
    v.normalize(b"-")
    assert (v.ref, v.obs, v.start, v.end) == (b"TT", b"-", 17, 18)

    v = V("chr1", 17, 19, b"TAT", b"TT")
    v.normalize(b"-")
    assert (v.ref, v.obs, v.start, v.end) == (b"A", b"-", 18, 18)

    v = V("chr1", 17, 19, b"TAT", b"TT")
    v.normalize(b"-", True)
    assert (v.ref, v.obs, v.start, v.end) == (b"A", b"-", 18, 18)

    v = V("chr18", 65, 65, b"A", b"AA")
    v.normalize(b"-")
    assert (v.ref, v.obs, v.start, v.end) == (b"-", b"A", 66, 66)

    v = V("chr18", 65, 65, b"A", b"ATA")
    v.normalize(b"-")
    assert (v.ref, v.obs, v.start, v.end) == (b"-", b"TA", 66, 66)


def test_variant_add_filter():
    """Variant_Test.cpp:412-428 (addFilter)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.io.gsvar import GSvarVariant

    v = GSvarVariant(Chromosome("chr1"), 120611964, 120611964, b"G", b"C", [b""])
    assert len(v.filters) == 0

    v.add_filter(b"off-target", 0)
    assert len(v.filters) == 1
    assert v.annotations[0] == b"off-target"

    v.add_filter(b"off-target2", 0)
    assert len(v.filters) == 2
    assert v.annotations[0] == b"off-target;off-target2"


def test_variant_from_string():
    """Variant_Test.cpp:430-451 (fromString)."""
    from ngsbits_tpu.io.gsvar import GSvarVariant

    cases = [
        ("chr1\t1423281\t1423281\tG\tA", "chr1:1423281-1423281 G>A"),
        ("chr14\t23371255\t23371255\t-\tGGC", "chr14:23371255-23371255 ->GGC"),
        ("chr11\t111742146\t111742146\tG\t-", "chr11:111742146-111742146 G>-"),
        ("chr17:41258507-41258507  G > A", "chr17:41258507-41258507 G>A"),
        ("chr17:41251845-41251846 AG  > -", "chr17:41251845-41251846 AG>-"),
        ("chr17:41256250-41256250 - >  T", "chr17:41256250-41256250 ->T"),
        ("chr17:41256250-41256250->T", "chr17:41256250-41256250 ->T"),
        ("chr17:41256250-41256250T>-", "chr17:41256250-41256250 T>-"),
    ]
    for text, expected in cases:
        assert GSvarVariant.from_string(text).to_string() == expected, text


# ---- VcfLine_Test.cpp (ungated methods) ------------------------------------


def _vcf_from_text(tmp_path, body, header_extra="", samples=("sample_1", "sample_2")):
    from ngsbits_tpu.io.vcf import VcfFile

    cols = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
    if samples:
        cols += "\tFORMAT\t" + "\t".join(samples)
    text = "##fileformat=VCFv4.2\n" + header_extra + cols + "\n" + body
    p = tmp_path / "t.vcf"
    p.write_text(text)
    return VcfFile.from_file(str(p))


def test_vcfline_construct_without_file(tmp_path):
    """VcfLine_Test.cpp:8-42 (constructLineWithoutFile)."""
    f = _vcf_from_text(tmp_path,
                       "chr4\t777\t.\tA\tT\t.\t.\t.\tGT:X\t1/1:A\t0/0:B\n")
    v = f[0]
    assert v.chr.str == "chr4"
    assert v.start == 777
    assert v.ref == b"A"
    assert v.alt_string() == b"T"
    assert v.format_keys() == [b"GT", b"X"]
    assert v.format_value_from_sample("GT", "sample_1") == b"1/1"
    assert v.format_value_from_sample("X", "sample_1") == b"A"
    assert v.format_value_from_sample("GT", "sample_2") == b"0/0"
    assert v.format_value_from_sample("X", "sample_2") == b"B"


def test_vcfline_header_line_lookup():
    """VcfLine_Test.cpp:45-93 (info/format/filterLineFromHeader)."""
    from ngsbits_tpu.io.vcf import VcfHeader

    header = VcfHeader()
    for i in range(10):
        header.add(f'##INFO=<ID={i},Number=1,Type=String,'
                   f'Description="description of info {i}">'.encode())
        header.add(f'##FORMAT=<ID={i},Number=1,Type=String,'
                   f'Description="description of format {i}">'.encode())
        header.add(f'##FILTER=<ID={i},'
                   f'Description="description of filter {i}">'.encode())

    assert header.info_line_by_id("3").description == b"description of info 3"
    assert header.info_line_by_id("X", False).id == ""
    assert header.format_line_by_id("3").description == b"description of format 3"
    assert header.filter_line_by_id("3").description == b"description of filter 3"


def test_vcfline_format_entry_for_sample(tmp_path):
    """VcfLine_Test.cpp:111-138 (formatEntryForSampleId)."""
    f = _vcf_from_text(
        tmp_path,
        "chr17\t72196817\t.\tG\tGA\t.\t.\t.\tGT:PL:GQ\t0/1:255,0,123:99\t"
        "1/1:255,84,0:33\n")
    assert len(f) == 1
    v = f[0]
    assert len(v.sample("sample_1")) == 3
    assert v.format_value_from_sample("GT", "sample_1") == b"0/1"
    assert len(v.sample(1)) == 3
    assert v.format_value_from_sample("GQ", "sample_2") == b"33"
    assert v.format_value_from_sample("GT", "sample_1") == b"0/1"
    assert v.format_value_from_sample("PL") == b"255,0,123"
    assert v.format_value_from_sample("PL", 1) == b"255,84,0"


def test_vcfline_is_classifiers(tmp_path):
    """VcfLine_Test.cpp:140-218 (isMultiAllelic/isIns/isDel/isInDel/isMNP)."""
    body = "".join(
        f"chr9\t130932396\t.\t{ref}\t{alt}\t.\t.\t.\n"
        for ref, alt in [("G", "A"), ("G", "A,C"), ("AACA", "AGG"),
                         ("AACA", "A"), ("A", "AGG"), ("A", "G"),
                         ("AACA", "GGGG"), ("AAC", "GGG"), ("AA", "GG")])
    f = _vcf_from_text(tmp_path, body, samples=())
    multi, ins, del_, indel, mnp = (
        [f[i].is_multi_allelic() for i in range(9)],
        [f[i].is_ins() for i in range(9)],
        [f[i].is_del() for i in range(9)],
        [f[i].is_indel() for i in range(9)],
        [f[i].is_mnp() for i in range(9)])
    assert multi == [False, True, False, False, False, False, False, False, False]
    # rows: SNV, multi, AACA>AGG, AACA>A, A>AGG, A>G, MNP4, MNP3, MNP2
    assert ins[2:6] == [False, False, True, False]
    assert del_[2:6] == [False, True, False, False]
    assert indel[2:6] == [True, False, False, False]
    assert mnp[2:9] == [False, False, False, False, True, True, True]


def test_vcfline_overlaps_and_lessthan(tmp_path):
    """VcfLine_Test.cpp:473-560 (overlapsWith*/operator_lessthan)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedLine

    f = _vcf_from_text(tmp_path,
                       "chr1\t5\t.\tNNNNNN\tNNNNNN\t.\t.\t.\n"
                       "chr1\t1\t.\tNNNNN\tNNNNN\t.\t.\t.\n"
                       "chr2\t1\t.\tNNNNN\tNNNNN\t.\t.\t.\n",
                       samples=())
    v = f[0]
    assert not v.overlaps_with("chr2", 5, 10)
    assert not v.overlaps_with("chr1", 1, 4)
    assert not v.overlaps_with("chr1", 11, 20)
    assert v.overlaps_with("chr1", 1, 5)
    assert v.overlaps_with("chr1", 5, 10)
    assert v.overlaps_with("chr1", 6, 8)
    assert v.overlaps_with("chr1", 10, 20)
    assert v.overlaps_with("chr1", 1, 20)

    assert v.overlaps_with(5, 10)
    assert not v.overlaps_with(1, 4)
    assert v.overlaps_with(1, 20)

    assert not v.overlaps_with(BedLine(Chromosome("chr2"), 5, 10))
    assert v.overlaps_with(BedLine(Chromosome("chr1"), 1, 5))

    v1, v5, c2 = f[1], f[0], f[2]
    assert v1 < v5
    assert not v5 < v1
    assert v5 < c2
    assert not c2 < v5
    assert not v1 < v1


# ---- VcfFile_Test.cpp (ungated methods) ------------------------------------


def _same_lines(a_path, b_path):
    with open(a_path, "rb") as fh:
        a = fh.read().rstrip(b"\n")
    with open(b_path, "rb") as fh:
        b = fh.read().rstrip(b"\n")
    assert a == b


def test_vcffile_remove_duplicates():
    """VcfFile_Test.cpp:9-36 (removeDuplicates_VCF/Empty)."""
    from ngsbits_tpu.io.vcf import VcfFile

    vl = VcfFile.from_file(f"{DIN}/panel_snpeff.vcf")
    assert not vl.is_sorted()
    vl.sort()
    assert vl.is_sorted()
    vl2 = VcfFile.from_file(f"{DIN}/variantList_removeDuplicates.vcf")
    vl2.remove_duplicates(True)
    assert len(vl) == len(vl2)
    for i in range(len(vl)):
        assert int(vl.pos[i]) == int(vl2.pos[i])
        assert vl.alts[i] == vl2.alts[i]

    empty = VcfFile()
    empty.remove_duplicates(True)
    assert len(empty) == 0


def test_vcffile_load():
    """VcfFile_Test.cpp:38-110 (loadFromVCF)."""
    from ngsbits_tpu.io.vcf import VcfFile

    vl = VcfFile.from_file(f"{DIN}/panel_snpeff.vcf")
    assert len(vl) == 14
    assert len(vl.header.comments) == 2
    assert vl.sample_ids()[0] == b"./Sample_GS120297A3/GS120297A3.bam"
    assert len(vl.header.info_lines) == 18
    assert len(vl.header.format_lines) == 6

    info = vl.header.info_line_by_id("INDEL")
    assert (info.id, info.type, info.number) == ("INDEL", b"Flag", b"0")
    assert info.description == b"Indicates that the variant is an INDEL."

    info = vl.header.info_line_by_id("DP4")
    assert (info.id, info.type, info.number) == ("DP4", b"Integer", b"4")
    assert info.description == (b"# high-quality ref-forward bases, "
                                b"ref-reverse, alt-forward and alt-reverse bases")

    fmt = vl.header.format_line_by_id("PL")
    assert (fmt.id, fmt.number, fmt.type) == ("PL", b"G", b"Integer")
    assert fmt.description == b"List of Phred-scaled genotype likelihoods"

    # 2 declared FILTER lines + auto-added low_DP (VcfFile.cpp:160-171)
    assert len(vl.header.filter_lines) == 3
    assert vl.header.filter_line_by_id("q10").description == b"Quality below 10"
    assert vl.header.filter_line_by_id("s50").description == \
        b"Less than 50% of samples have data"

    v = vl[0]
    assert (v.chr.str, v.start, v.end) == ("chr17", 72196817, 72196817)
    assert (v.ref, v.alt(0)) == (b"G", b"GA")
    assert v.info("INDEL") == b"TRUE"
    assert v.info("DP4") == b"4,3,11,11"
    second_format = v.format_keys()[1].decode()
    assert v.format_value_from_sample(second_format,
                                      vl.sample_ids()[0]) == b"255,0,123"
    assert len(v.filters) == 0
    assert vl[11].filters == [b"low_DP"]

    v = vl[12]
    assert (v.chr.str, v.start, v.end) == ("chr9", 130931421, 130931421)
    assert (v.ref, v.alt(0)) == (b"G", b"A")
    assert v.info("DP") == b"2512"
    assert v.info("INDEL") == b""
    assert v.info("DP4") == b"457,473,752,757"
    assert v.format_value_from_sample(v.format_keys()[1].decode(), 0) == \
        b"255,0,255"

    vl = VcfFile.from_file(f"{DIN}/panel_snpeff.vcf")
    assert len(vl) == 14
    assert len(vl.header.info_lines) == 18


def test_vcffile_store_compressions(tmp_path):
    """VcfFile_Test.cpp:112-138 (loadVCFWithNewFilter) — plain + bgzf store."""
    from ngsbits_tpu.io.vcf import VcfFile, vcf_store

    vl = VcfFile.from_file(f"{DIN}/VcfFileHandler_in.vcf")
    out = str(tmp_path / "h.vcf")
    vcf_store(vl, out)
    _same_lines(out, f"{NGS_TEST}/data_out/VcfFileHandler_out.vcf")

    gz = str(tmp_path / "h.vcf.gz")
    vcf_store(vl, gz, compression_level=9)
    vl2 = VcfFile.from_file(gz)
    out2 = str(tmp_path / "h2.vcf")
    vcf_store(vl2, out2)
    _same_lines(out2, f"{NGS_TEST}/data_out/VcfFileHandler_out.vcf")

    gz5 = str(tmp_path / "h5.vcf.gz")
    vcf_store(vl2, gz5, compression_level=5)
    vl3 = VcfFile.from_file(gz5)
    out3 = str(tmp_path / "h3.vcf")
    vcf_store(vl3, out3)
    _same_lines(out3, f"{NGS_TEST}/data_out/VcfFileHandler_out.vcf")


def test_vcffile_load_with_roi():
    """VcfFile_Test.cpp:140-164 (loadFromVCF_withROI)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine
    from ngsbits_tpu.io.vcf import VcfFile

    roi = BedFile()
    roi.append(BedLine(Chromosome("chr17"), 72196820, 72196892))
    roi.append(BedLine(Chromosome("chr18"), 67904549, 67904670))

    vl = VcfFile.from_file(f"{DIN}/panel_snpeff.vcf", roi=roi)
    assert len(vl) == 4
    assert len(vl.header.comments) == 2
    assert vl.sample_ids() == [b"./Sample_GS120297A3/GS120297A3.bam"]
    assert len(vl.header.info_lines) == 18
    assert len(vl.header.format_lines) == 6
    assert [(vl[i].chr.str, vl[i].start) for i in range(4)] == [
        ("chr17", 72196887), ("chr17", 72196892),
        ("chr18", 67904549), ("chr18", 67904586)]


def test_vcffile_no_sample_or_format():
    """VcfFile_Test.cpp:166-176 (loadFromVCF_noSampleOrFormatColumn)."""
    from ngsbits_tpu.io.vcf import VcfFile

    vl = VcfFile.from_file(f"{DIN}/VariantList_loadFromVCF_noFormatSample.vcf")
    assert len(vl) == 14
    assert len(vl.header.info_lines) == 18
    assert len(vl.header.format_lines) == 6
    assert len(vl.header.comments) == 1
    assert vl.header.fileformat == b"VCFv4.1"
    assert vl.sample_ids() == []


def test_vcffile_undeclared_annotations():
    """VcfFile_Test.cpp:178-203 (loadFromVCF_undeclaredAnnotations)."""
    from ngsbits_tpu.io.vcf import VcfFile

    vl = VcfFile.from_file(
        f"{DIN}/VariantList_loadFromVCF_undeclaredAnnotations.vcf")
    assert len(vl) == 2
    assert len(vl.header.info_lines) == 5
    assert len(vl.header.format_lines) == 10
    names = ([i for i, _l in vl.header.info_lines]
             + [i for i, _l in vl.header.format_lines])
    assert ",".join(names) == "DP,AF,RO,AO,CIGAR,GT,GQ,GL,DP,RO,QR,AO,QA,TRIO,TRIO2"

    assert vl[0].info("CIGAR") == b"1X"
    assert vl[1].info("CIGAR") == b""
    assert vl[0].format_value_from_sample("TRIO2") == b""
    assert vl[1].format_value_from_sample("TRIO2") == \
        b"HET,9,0.56,WT,17,0.00,HOM,19,1.00"


def test_vcffile_empty_format_and_info(tmp_path):
    """VcfFile_Test.cpp:205-215 (loadFromVCF_emptyFormatAndInfo)."""
    from ngsbits_tpu.io.vcf import VcfFile, vcf_store

    src = f"{DIN}/VariantList_loadFromVCF_emptyInfoAndFormat.vcf"
    out = str(tmp_path / "empty.vcf")
    vl = VcfFile.from_file(src)
    vcf_store(vl, out)
    _same_lines(src, out)


def test_vcffile_store_reload(tmp_path):
    """VcfFile_Test.cpp:217-287 (storeToVCF)."""
    from ngsbits_tpu.io.vcf import VcfFile, vcf_store

    vl = VcfFile.from_file(f"{DIN}/panel_snpeff.vcf")
    out = str(tmp_path / "store01.vcf")
    vcf_store(vl, out)

    vl = VcfFile.from_file(out)
    assert len(vl) == 14
    assert len(vl.header.comments) == 2
    assert vl.sample_ids()[0] == b"./Sample_GS120297A3/GS120297A3.bam"


def test_vcffile_empty_descriptions_filled(tmp_path):
    """VcfFile_Test.cpp:289-324 (checkThatEmptyVariantAnnotationsAreFilled)."""
    from ngsbits_tpu.io.vcf import VcfFile, vcf_store

    vl = VcfFile.from_file(f"{DIN}/VariantList_emptyDescriptions.vcf")
    out = str(tmp_path / "fixed.vcf")
    vcf_store(vl, out)

    vl2 = VcfFile.from_file(out)
    assert len(vl2) == 14
    assert len(vl.header.info_lines) == 18
    assert len(vl.header.format_lines) == 6
    for iid, _line in vl2.header.info_lines:
        desc = vl2.header.info_line_by_id(iid).description
        if iid == "MQ":
            assert desc == b"no description available"
        else:
            assert desc != b"no description available"
    for fid, _line in vl2.header.format_lines:
        desc = vl2.header.format_line_by_id(fid).description
        if fid == "GQ":
            assert desc == b"no description available"
        else:
            assert desc != b"no description available"


def test_vcffile_load_gz():
    """VcfFile_Test.cpp:326-362 (loadFromVCF_GZ)."""
    from ngsbits_tpu.io.vcf import VcfFile

    vl = VcfFile.from_file(f"{DIN}/VariantList_load_zipped.vcf.gz")
    assert len(vl) == 157
    assert len(vl.header.info_lines) == 64
    assert len(vl.header.format_lines) == 8
    assert vl.header.info_lines[0][0] == "NS"
    assert vl.header.info_lines[63][0] == "EXAC_AF"

    v = vl[0]
    assert (v.chr.str, v.start, v.end) == ("chr1", 27687466, 27687466)
    assert (v.ref, v.alt(0)) == (b"G", b"T")
    assert v.id == b"rs35659744"
    assert f"{v.qual_value():g}" == "11836.9"
    assert list(v.filters) == []
    assert v.info("AC") == b"1"
    assert v.info("EXAC_AF") == b"0.223"

    v = vl[156]
    assert (v.chr.str, v.start, v.end) == ("chr20", 48301146, 48301146)
    assert (v.ref, v.alt(0)) == (b"G", b"A")
    assert v.id == b"rs6512586"
    assert f"{v.qual_value():g}" == "39504.2"
    assert v.info("NS") == b"1"
    assert v.info("AC") == b"2"
    assert v.info("EXAC_AF") == b"0.516"


def test_vcffile_vep_index_by_name():
    """VcfFile_Test.cpp:364-373 (vepIndexByName)."""
    from ngsbits_tpu.io.vcf import VcfFile

    vl = VcfFile.from_file(f"{DIN}/panel_vep.vcf")
    assert vl.header.vep_index_by_name("Allele", False) == 0
    assert vl.header.vep_index_by_name("Consequence", False) == 1
    assert vl.header.vep_index_by_name("IMPACT", False) == 2
    assert vl.header.vep_index_by_name("HGMD_PHEN", False) == 59
    assert vl.header.vep_index_by_name("Oranguta-Klaus", False) == -1


def test_vcffile_sort_golden(tmp_path):
    """VcfFile_Test.cpp:375-383 (sort)."""
    from ngsbits_tpu.io.vcf import VcfFile, vcf_store

    vl = VcfFile.from_file(f"{DIN}/sort_in.vcf")
    vl.sort()
    out = str(tmp_path / "sort_out.vcf")
    vcf_store(vl, out)
    _same_lines(out, f"{NGS_TEST}/data_out/sort_out.vcf")


def test_vcffile_sort3():
    """VcfFile_Test.cpp:420-448 (sort3) — numeric chromosome order."""
    from ngsbits_tpu.io.vcf import VcfFile

    vl = VcfFile.from_file(f"{DIN}/panel_snpeff.vcf")
    vl.sort()
    expected = [("chr1", 11676308), ("chr1", 11676377), ("chr2", 139498511),
                ("chr4", 68247038), ("chr4", 68247113), ("chr9", 130931421),
                ("chr9", 130932396), ("chr17", 72196817), ("chr17", 72196887),
                ("chr17", 72196892), ("chr18", 67904549), ("chr18", 67904586),
                ("chr18", 67904672), ("chr19", 14466629)]
    assert [(vl[i].chr.str, vl[i].start) for i in range(14)] == expected


def test_vcffile_sort_by_file():
    """VcfFile_Test.cpp:450-479 (sortByFile) — reverse-numeric fai order."""
    from ngsbits_tpu.io.vcf import VcfFile

    vl = VcfFile.from_file(f"{DIN}/panel_snpeff.vcf")
    vl.sort_by_file(f"{DIN}/variantList_sortbyFile.fai")
    expected = [("chr19", 14466629), ("chr18", 67904549), ("chr18", 67904586),
                ("chr18", 67904672), ("chr17", 72196817), ("chr17", 72196887),
                ("chr17", 72196892), ("chr9", 130931421), ("chr9", 130932396),
                ("chr4", 68247038), ("chr4", 68247113), ("chr2", 139498511),
                ("chr1", 11676308), ("chr1", 11676377)]
    assert [(vl[i].chr.str, vl[i].start) for i in range(14)] == expected


def test_vcffile_store_as_tsv(tmp_path):
    """VcfFile_Test.cpp:481-490 (storeAsTsv)."""
    from ngsbits_tpu.io.vcf import VcfFile, vcf_store_as_tsv

    vl = VcfFile.from_file(f"{DIN}/panel_snpeff.vcf")
    out = str(tmp_path / "storeAsTsv.tsv")
    vcf_store_as_tsv(vl, out)
    _same_lines(out, f"{NGS_TEST}/data_out/VcfFile_storeAsTsv.tsv")


def test_vcffile_sample_info_format_ids():
    """VcfFile_Test.cpp:552-590 (getSampleIds/getInfoIds/getFormatIds)."""
    from ngsbits_tpu.io.vcf import VcfFile

    vl = VcfFile.from_file(f"{DIN}/VcfFileHandler_in.vcf")
    assert vl.sample_ids() == [b"normal", b"tumor"]

    assert len(vl.header.info_lines) == 23
    assert vl.header.info_lines[0][0] == "CSQ"
    assert vl.header.info_lines[2][0] == "IC"
    assert vl.header.info_lines[16][0] == "TQSS_NT"

    assert len(vl.header.format_lines) == 16
    assert vl.header.format_lines[0][0] == "GT"
    assert vl.header.format_lines[15][0] == "SUBDP"


def test_vcffile_url_encoding():
    """VcfFile_Test.cpp:632-644 (vcf_url_encoding/decoding)."""
    from ngsbits_tpu.io.vcf import decode_info_value, encode_info_value

    raw = "Test-String= blabla%, \t; \r\n; \r"
    encoded = "Test-String%3D%20blabla%25%2C%20%09%3B%20%0D%0A%3B%20%0D"
    assert encode_info_value(raw) == encoded
    assert decode_info_value(encoded) == raw


def test_vcffile_load_store_comparison(tmp_path):
    """VcfFile_Test.cpp:701-739 (convertToStringAndParseFromString /
    loadStoreComparison)."""
    from ngsbits_tpu.io.vcf import VcfFile, vcf_store

    vl = VcfFile.from_file(f"{DIN}/panel_vep.vcf")
    text = vl.to_text()
    vl2 = VcfFile.from_text(text)
    out = str(tmp_path / "panel_vep_roundtrip.vcf")
    vcf_store(vl2, out)
    _same_lines(out, f"{DIN}/panel_vep.vcf")

    out2 = str(tmp_path / "panel_vep_loadStore.vcf")
    vcf_store(vl, out2)
    _same_lines(out2, f"{DIN}/panel_vep.vcf")


# ---- FilterCascade_Test.cpp ------------------------------------------------


def _load_gsvar(name):
    from ngsbits_tpu.io.gsvar import GSvarFile

    return GSvarFile.from_file(f"{DIN}/{name}")


def _load_cnvs(name):
    from ngsbits_tpu.io.cnv import CnvList

    return CnvList.from_file(f"{DIN}/{name}")


def _load_svs(name):
    from ngsbits_tpu.io.bedpe import BedpeFile

    return BedpeFile.from_file(f"{DIN}/{name}")


def _apply_filter(target, name, params=None, result=None, initial=True):
    from ngsbits_tpu.filters.cascade import FilterResult, create_filter

    n = len(target.variants) if hasattr(target, "variants") else len(target)
    if result is None:
        result = FilterResult(n)
        if not initial:
            result.reset(False)
    f = create_filter(name)
    for k, v in (params or {}).items():
        f.set_param(k, v if isinstance(v, str) else str(v))
    f.apply(target, result)
    return result


def test_fc_factory_names():
    """FilterCascade_Test.cpp:9-28 (FilterFactory_filterNames)."""
    from ngsbits_tpu.filters.cascade import filter_names

    names = filter_names()
    assert "Allele frequency" in names
    assert "CNV size" in names
    count_all = len(names)

    snv = filter_names("snv")
    assert "Allele frequency" in snv
    assert "CNV size" not in snv
    assert len(snv) < count_all

    cnv = filter_names("cnv")
    assert "Allele frequency" not in cnv
    assert "CNV size" in cnv
    assert len(cnv) < count_all


def test_fc_allele_frequency():
    """FilterCascade_Test.cpp:32-64."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    r = _apply_filter(vl, "Allele frequency", {"max_af": "1.0"})
    assert r.count_passing() == 22
    for i in (70, 74, 101, 120):
        assert r.flags[i]

    vl2 = _load_gsvar("VariantFilter_no1000g_in.GSvar")
    r = _apply_filter(vl2, "Allele frequency", {"max_af": "1.0"})
    assert r.count_passing() == 29
    for i in (70, 74, 101, 120):
        assert r.flags[i]

    r = _apply_filter(vl, "Allele frequency (sub-populations)", {"max_af": "1.0"})
    assert r.count_passing() == 9


def test_fc_regions():
    """FilterCascade_Test.cpp:80-125 (FilterRegions single + multi region)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine
    from ngsbits_tpu.filters.cascade import FilterResult, filter_regions_apply

    vl = _load_gsvar("VariantFilter_in.GSvar")
    assert vl.annotation_index_by_name("filter") == 1

    r = FilterResult(len(vl))
    bed = BedFile()
    bed.append(BedLine(Chromosome("chr1"), 27687465, 27687467))
    filter_regions_apply(vl, bed, r)
    assert r.count_passing() == 1
    assert r.flags[0]

    r.tag_non_passing(vl, "off-target", "Variants outside target region")
    assert vl.annotation_index_by_name("filter") == 1
    assert sum(1 for v in vl.variants if b"off-target" in v.filters) == 142

    vl = _load_gsvar("VariantFilter_in.GSvar")
    r = FilterResult(len(vl))
    bed = BedFile()
    bed.append(BedLine(Chromosome("chr1"), 62728830, 62728870))
    bed.append(BedLine(Chromosome("chr17"), 41244430, 41245240))
    filter_regions_apply(vl, bed, r)
    assert r.count_passing() == 5
    for i in (5, 6, 134, 135, 136):
        assert r.flags[i]
    r.remove_flagged(vl)
    assert len(vl) == 5


def test_fc_simple_snv_filters():
    """FilterCascade_Test.cpp:127-148, 306-318, 932-971, 1049-1176 — one-shot
    pinned counts on VariantFilter_in.GSvar."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    cases = [
        ("Filter column empty", {}, 109),
        ("SNVs only", {}, 135),
        ("Gene constraint", {"max_oe_lof": "0.1"}, 1),
        ("OMIM genes", {}, 108),
        ("Conservedness", {"min_score": "2.0"}, 16),
        ("Regulatory", {"action": "FILTER"}, 2),
        ("RNA ASE allele frequency", {"min_af": "0.33", "max_af": "0.66"}, 41),
        ("RNA ASE alternative count", {"min_ac": "17"}, 91),
        ("RNA ASE depth", {"min_depth": "26"}, 110),
        ("RNA ASE p-value", {"max_pval": "0.2"}, 13),
        ("RNA aberrant splicing fraction", {"min_asf": "0.05"}, 17),
        ("RNA expression fold-change", {"min_fc": "1.5"}, 17),
        ("RNA expression z-score", {"min_zscore": "1.25"}, 22),
        ("RNA gene expression", {"min_tpm": "35"}, 18),
        ("lr short-read overlap", {"invert": "false"}, 42),
        ("Variant type", {}, 77),
    ]
    for name, params, expected in cases:
        r = _apply_filter(vl, name, params)
        assert r.count_passing() == expected, name


def test_fc_genes():
    """FilterCascade_Test.cpp:151-187 (FilterGenes wildcards)."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    for genes, expected in [("TP53", 1), ("TP53,BRCA1", 8), ("BRCA*", 12),
                            ("*-*", 8), ("BRCA*,TP*", 19)]:
        r = _apply_filter(vl, "Genes", {"genes": genes})
        assert r.count_passing() == expected, genes


def test_fc_impact():
    """FilterCascade_Test.cpp:189-209."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    r = _apply_filter(vl, "Impact", {"impact": "HIGH"})
    assert r.count_passing() == 2
    assert r.flags[19] and r.flags[47]
    r = _apply_filter(vl, "Impact", {"impact": "HIGH,MODERATE"})
    assert r.count_passing() == 60


def test_fc_count_ngsd():
    """FilterCascade_Test.cpp:211-239."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    r = _apply_filter(vl, "Count NGSD",
                      {"max_count": "5", "ignore_genotype": "false"})
    assert r.count_passing() == 3
    assert r.flags[70] and r.flags[92] and r.flags[120]
    r = _apply_filter(vl, "Count NGSD",
                      {"max_count": "50", "ignore_genotype": "false"})
    assert r.count_passing() == 9
    r = _apply_filter(vl, "Count NGSD",
                      {"max_count": "50", "ignore_genotype": "true"})
    assert r.count_passing() == 8


def test_fc_classification_ngsd():
    """FilterCascade_Test.cpp:241-269."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    r = _apply_filter(vl, "Classification NGSD",
                      {"action": "REMOVE", "classes": "1,2"})
    assert r.count_passing() == 106
    r = _apply_filter(vl, "Classification NGSD",
                      {"action": "FILTER", "classes": "3,4,5"})
    assert r.count_passing() == 1
    r = _apply_filter(vl, "Classification NGSD",
                      {"action": "KEEP", "classes": "2,3"}, initial=False)
    assert r.count_passing() == 6


def test_fc_filter_columns():
    """FilterCascade_Test.cpp:271-304."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    r = _apply_filter(vl, "Filter columns",
                      {"action": "REMOVE", "entries": "low_MQM"})
    assert r.count_passing() == 132
    r = _apply_filter(vl, "Filter columns",
                      {"action": "REMOVE", "entries": "low_MQM,low_DP"})
    assert r.count_passing() == 125
    r = _apply_filter(vl, "Filter columns",
                      {"action": "KEEP", "entries": "low_DP"}, initial=False)
    assert r.count_passing() == 7
    r = _apply_filter(vl, "Filter columns",
                      {"action": "FILTER", "entries": "low_MQM"})
    assert r.count_passing() == 11


def test_fc_gene_inheritance():
    """FilterCascade_Test.cpp:320-341."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    for modes, expected in [("AD", 19), ("AR", 28), ("AD,AR", 44)]:
        r = _apply_filter(vl, "Gene inheritance", {"modes": modes})
        assert r.count_passing() == expected, modes


def test_fc_column_match_regexp():
    """FilterCascade_Test.cpp:343-372."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    r = _apply_filter(vl, "Column match",
                      {"action": "REMOVE", "column": "OMIM", "pattern": "^$"})
    assert r.count_passing() == 108
    r = _apply_filter(vl, "Column match",
                      {"action": "KEEP", "column": "OMIM", "pattern": "^$"},
                      initial=False)
    assert r.count_passing() == 35
    r = _apply_filter(vl, "Column match",
                      {"action": "FILTER", "column": "dbSNP", "pattern": "^$"})
    assert r.count_passing() == 3


def test_fc_genotype_control_multi():
    """FilterCascade_Test.cpp:374-406."""
    vl = _load_gsvar("VariantFilter_in_multi.GSvar")
    r = _apply_filter(vl, "Genotype control", {"genotypes": "hom"})
    assert r.count_passing() == 103
    r = _apply_filter(vl, "Genotype control", {"genotypes": "het"})
    assert r.count_passing() == 53
    r = _apply_filter(vl, "Genotype control",
                      {"genotypes": "wt,het", "same_genotype": "false"})
    assert r.count_passing() == 153
    r = _apply_filter(vl, "Genotype control",
                      {"genotypes": "wt,het", "same_genotype": "true"})
    assert r.count_passing() == 152


def test_fc_genotype_affected():
    """FilterCascade_Test.cpp:408-463."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    assert _apply_filter(vl, "Genotype affected",
                         {"genotypes": "hom"}).count_passing() == 57
    assert _apply_filter(vl, "Genotype affected",
                         {"genotypes": "het"}).count_passing() == 86

    vl = _load_gsvar("VariantFilter_in_multi.GSvar")
    for genotypes, expected in [("hom", 65), ("het", 95), ("wt", 14),
                                ("wt,het", 109)]:
        r = _apply_filter(vl, "Genotype affected",
                          {"genotypes": genotypes, "same_genotype": "true"})
        assert r.count_passing() == expected, genotypes


def test_fc_genotype_affected_comphet():
    """FilterCascade_Test.cpp:465-523."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine
    from ngsbits_tpu.filters.cascade import FilterResult, filter_regions_apply

    for extra_genotypes, expected in [("comp-het", 3), ("comp-het,hom", 6)]:
        vl = _load_gsvar("VariantFilter_in.GSvar")
        r = FilterResult(len(vl))
        bed = BedFile()
        bed.append(BedLine(Chromosome("chr1"), 1, 248956422))
        filter_regions_apply(vl, bed, r)
        r = _apply_filter(vl, "Impact", {"impact": "HIGH,MODERATE"}, result=r)
        assert r.count_passing() == 9
        r = _apply_filter(vl, "Genotype affected",
                          {"genotypes": extra_genotypes}, result=r)
        assert r.count_passing() == expected, extra_genotypes

    for extra_genotypes, expected in [("comp-het", 2), ("comp-het,hom", 3)]:
        vl = _load_gsvar("VariantFilter_in_multi.GSvar")
        r = _apply_filter(vl, "Allele frequency", {"max_af": "1.0"})
        assert r.count_passing() == 39
        r = _apply_filter(vl, "Genotype affected",
                          {"genotypes": extra_genotypes}, result=r)
        assert r.count_passing() == expected, extra_genotypes


def test_fc_genotype_affected_comphet_phased():
    """FilterCascade_Test.cpp:543-579."""
    vl = _load_gsvar("VariantFilter_in_phased.GSvar")
    assert _apply_filter(vl, "Genotype affected",
                         {"genotypes": "comp-het"}).count_passing() == 187
    assert _apply_filter(vl, "Genotype affected",
                         {"genotypes": "comp-het (phased)"}).count_passing() == 68
    assert _apply_filter(vl, "Genotype affected",
                         {"genotypes": "comp-het (unphased)"}).count_passing() == 89
    for combo in ("comp-het,comp-het (phased)", "comp-het,comp-het (unphased)",
                  "comp-het (phased),comp-het (unphased)"):
        with pytest.raises(ValueError):
            _apply_filter(vl, "Genotype affected", {"genotypes": combo})


def test_fc_annotation_pathogenic():
    """FilterCascade_Test.cpp:581-642."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    cases = [
        ({"sources": "HGMD,ClinVar", "also_likely_pathogenic": "true",
          "action": "FILTER"}, True, 5),
        ({"sources": "HGMD,ClinVar", "also_likely_pathogenic": "false",
          "action": "FILTER"}, True, 2),
        ({"sources": "HGMD,ClinVar", "also_likely_pathogenic": "true",
          "action": "KEEP"}, False, 5),
        ({"sources": "HGMD,ClinVar", "also_likely_pathogenic": "false",
          "action": "KEEP"}, False, 2),
        ({"sources": "ClinVar", "also_likely_pathogenic": "true",
          "action": "KEEP"}, False, 1),
        ({"sources": "ClinVar", "also_likely_pathogenic": "false",
          "action": "KEEP"}, False, 1),
        ({"sources": "HGMD", "also_likely_pathogenic": "true",
          "action": "KEEP"}, False, 4),
        ({"sources": "HGMD", "also_likely_pathogenic": "false",
          "action": "KEEP"}, False, 1),
    ]
    for params, initial, expected in cases:
        r = _apply_filter(vl, "Annotated pathogenic", params, initial=initial)
        assert r.count_passing() == expected, params


def test_fc_prediction_pathogenic():
    """FilterCascade_Test.cpp:644-668."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    r = _apply_filter(vl, "Predicted pathogenic", {"action": "FILTER", "min": "1"})
    assert r.count_passing() == 17
    r = _apply_filter(vl, "Predicted pathogenic", {"action": "FILTER", "min": "2"},
                      result=r)
    assert r.count_passing() == 0
    r = _apply_filter(vl, "Predicted pathogenic", {"action": "KEEP", "min": "1"},
                      initial=False)
    assert r.count_passing() == 17


def test_fc_annotation_text():
    """FilterCascade_Test.cpp:670-697."""
    vl = _load_gsvar("VariantFilter_in.GSvar")
    r = _apply_filter(vl, "Text search", {"action": "FILTER", "term": "bReast cancer"})
    assert r.count_passing() == 26
    r = _apply_filter(vl, "Text search", {"action": "KEEP", "term": "ataXIA"},
                      initial=False)
    assert r.count_passing() == 4
    r = _apply_filter(vl, "Text search", {"action": "REMOVE", "term": "ataXIA"})
    assert r.count_passing() == 139


def test_fc_variant_qc():
    """FilterCascade_Test.cpp:712-881 (FilterVariantQC single + multi)."""
    base = {"apply_to": "all", "qual": "0", "depth": "0", "min_gq": "0",
            "min_af": "0", "max_af": "1", "remove_special_calls": "false"}
    vl = _load_gsvar("VariantFilter_in.GSvar")
    cases = [
        ({}, 143), ({"qual": "200"}, 138),
        ({"qual": "200", "apply_to": "SNV"}, 139),
        ({"qual": "200", "apply_to": "INDEL"}, 142),
        ({"depth": "20"}, 136), ({"min_gq": "20"}, 142),
        ({"min_af": "0.3"}, 133), ({"max_af": "0.3"}, 10),
        ({"remove_special_calls": "true"}, 142),
    ]
    for override, expected in cases:
        r = _apply_filter(vl, "Variant quality", {**base, **override})
        assert r.count_passing() == expected, override

    vl = _load_gsvar("VariantFilter_in_multi.GSvar")
    for override, expected in [({}, 256), ({"qual": "20", "depth": "20"}, 193),
                               ({"min_gq": "20"}, 254),
                               ({"remove_special_calls": "true"}, 254)]:
        r = _apply_filter(vl, "Variant quality", {**base, **override})
        assert r.count_passing() == expected, override


def test_fc_trio():
    """FilterCascade_Test.cpp:883-930."""
    vl = _load_gsvar("VariantFilter_in_trio.GSvar")
    assert _apply_filter(vl, "Trio", {}).count_passing() == 17
    for types, expected in [("de-novo", 2), ("recessive", 2), ("comp-het", 4),
                            ("LOH", 3), ("x-linked", 6), ("imprinting", 2)]:
        r = _apply_filter(vl, "Trio", {"types": types})
        assert r.count_passing() == expected, types


def test_fc_splice_effect():
    """FilterCascade_Test.cpp:973-1047."""
    vl = _load_gsvar("VariantFilter_in_newer_Annotation_in.GSvar")
    r = _apply_filter(vl, "Splice effect",
                      {"action": "FILTER", "MaxEntScan": "LOW", "SpliceAi": "0"})
    assert r.count_passing() == len(r.flags)
    cases_filter = [("MODERATE", "0", 2), ("HIGH", "0", 1), ("LOW", "0.2", 5),
                    ("MODERATE", "0.4", 3)]
    for mes, sai, expected in cases_filter:
        r = _apply_filter(vl, "Splice effect",
                          {"action": "FILTER", "MaxEntScan": mes, "SpliceAi": sai})
        assert r.count_passing() == expected, (mes, sai)
    cases_keep = [("MODERATE", "0.4", 3), ("MODERATE", "0", 2), ("LOW", "0.2", 5),
                  ("LOW", "0", 0)]
    for mes, sai, expected in cases_keep:
        r = _apply_filter(vl, "Splice effect",
                          {"action": "KEEP", "MaxEntScan": mes, "SpliceAi": sai},
                          initial=False)
        assert r.count_passing() == expected, (mes, sai)


def test_fc_somatic_allele_frequency():
    """FilterCascade_Test.cpp:1179-1220."""
    vl = _load_gsvar("VariantFilter_in_somatic_tumor_only.GSvar")
    r = _apply_filter(vl, "Somatic allele frequency",
                      {"min_af_tum": "50.0", "max_af_nor": "100.0"})
    assert r.count_passing() == 6
    with pytest.raises(ValueError):
        _apply_filter(vl, "Somatic allele frequency",
                      {"min_af_tum": "50.0", "max_af_nor": "5.0"})

    vl = _load_gsvar("VariantFilter_in_somatic_tumor_normal.GSvar")
    r = _apply_filter(vl, "Somatic allele frequency",
                      {"min_af_tum": "15.0", "max_af_nor": "100.0"})
    assert r.count_passing() == 5
    r = _apply_filter(vl, "Somatic allele frequency",
                      {"min_af_tum": "15.0", "max_af_nor": "2.0"})
    assert r.count_passing() == 4


def test_fc_cnv_filters():
    """FilterCascade_Test.cpp:1222-1440 — CNV filter pinned counts."""
    cnvs = _load_cnvs("CnvList_ClinCNV_germline.tsv")
    r = _apply_filter(cnvs, "CNV size", {"size": "20.0"})
    assert r.count_passing() == 2
    r = _apply_filter(cnvs, "CNV size", {"size": "17.0", "action": "KEEP"},
                      initial=False)
    assert r.count_passing() == 3
    assert _apply_filter(cnvs, "CNV regions",
                         {"regions": "4"}).count_passing() == 1
    assert _apply_filter(cnvs, "CNV copy-number",
                         {"cn": "1"}).count_passing() == 37
    assert _apply_filter(cnvs, "CNV allele frequency",
                         {"max_af": "0.02"}).count_passing() == 6
    assert _apply_filter(cnvs, "CNV log-likelihood",
                         {"min_ll": "11.0",
                          "scale_by_regions": "false"}).count_passing() == 2
    assert _apply_filter(cnvs, "CNV log-likelihood",
                         {"min_ll": "7.0",
                          "scale_by_regions": "true"}).count_passing() == 7
    assert _apply_filter(cnvs, "CNV q-value",
                         {"max_q": "0.0001"}).count_passing() == 2
    assert _apply_filter(cnvs, "CNV OMIM genes", {}).count_passing() == 20
    assert _apply_filter(cnvs, "CNV polymorphism region",
                         {"max_ol": "0.001"}).count_passing() == 65

    multi = _load_cnvs("CnvList_ClinCNV_germline_multi.tsv")
    assert _apply_filter(multi, "CNV log-likelihood",
                         {"min_ll": "200.0"}).count_passing() == 7
    assert _apply_filter(multi, "CNV q-value",
                         {"max_q": "0.0"}).count_passing() == 20

    trio = _load_cnvs("CnvList_ClinCNV_germline_trio_with_regions.tsv")
    assert _apply_filter(trio, "CNV log-likelihood",
                         {"min_ll": "20.0",
                          "scale_by_regions": "true"}).count_passing() == 7

    som = _load_cnvs("CnvList_ClinCNV_somatic.tsv")
    assert _apply_filter(som, "CNV pathogenic CNV overlap",
                         {}).count_passing() == 3
    assert _apply_filter(som, "CNV pathogenic CNV overlap",
                         {"action": "KEEP"}, initial=False).count_passing() == 3


def test_fc_cnv_comphet():
    """FilterCascade_Test.cpp:1372-1385 (CNV-SNV/INDEL comp-het)."""
    from ngsbits_tpu.filters.cascade import FilterResult, create_filter

    cnvs = _load_cnvs("CnvList_ClinCNV_germline.tsv")
    f = create_filter("CNV compound-heterozygous")
    f.set_param("mode", "CNV-SNV/INDEL")
    f.het_hit_genes = {b"SKI", b"PER3", b"BRCA1", b"BRCA2", b"TP53"}
    r = FilterResult(len(cnvs))
    f.apply(cnvs, r)
    assert r.count_passing() == 2


def test_fc_cnv_default_cascades():
    """FilterCascade_Test.cpp:1442-1472 (default ClinCNV cascade)."""
    from ngsbits_tpu.filters.cascade import FilterCascade

    cascade = FilterCascade.load_from_file(f"{DIN}/CnvList_filters.ini",
                                           "default filter (ClinCNV)")
    cnvs = _load_cnvs("CnvList_ClinCNV_germline.tsv")
    assert cascade.apply(cnvs, "cnv", True).count_passing() == 0

    trio = _load_cnvs("CnvList_ClinCNV_germline_trio_with_regions.tsv")
    assert cascade.apply(trio, "cnv", True).count_passing() == 116

    som = _load_cnvs("CnvList_ClinCNV_somatic.tsv")
    assert cascade.apply(som, "cnv", False).count_passing() == 31


def test_fc_sv_filters():
    """FilterCascade_Test.cpp:1475-1921 — SV filter pinned counts."""
    svs = _load_svs("SV_Manta_germline.bedpe")
    cases = [
        ("SV type", {"Structural variant type": "DEL"}, 29),
        ("SV remove chr type", {}, 74),
        ("SV genotype affected", {"genotypes": "hom"}, 43),
        ("SV quality", {"quality": "365"}, 72),
        ("SV filter columns", {"entries": "AMBIGUOUS", "action": "REMOVE"}, 74),
        ("SV filter columns", {"entries": "MaxDepth", "action": "FILTER"}, 2),
        ("SV filter columns", {"entries": "MaxDepth,SampleFT",
                               "action": "FILTER"}, 7),
        ("SV paired read AF", {"Paired Read AF": "0.4"}, 8),
        ("SV split read AF", {"Split Read AF": "0.2"}, 11),
        ("SV PE read depth", {"PE Read Depth": "10"}, 35),
        ("SV gene constraint", {}, 21),
        ("SV size", {"min_size": "100", "max_size": "600"}, 33),
        ("SV OMIM genes", {"action": "FILTER"}, 12),
        ("SV OMIM genes", {"action": "REMOVE"}, 75),
        ("SV count NGSD", {}, 84),
        ("SV count NGSD", {"ignore_genotype": "true"}, 76),
        ("SV count NGSD", {"max_count": "10", "ignore_genotype": "true"}, 71),
        ("SV allele frequency NGSD", {}, 78),
        ("SV allele frequency NGSD", {"max_af": "50.0"}, 83),
        ("SV break point density NGSD", {}, 85),
        ("SV break point density NGSD", {"max_density": "4",
                                         "remove_strict": "true"}, 82),
        ("SV break point density NGSD", {"max_density": "1",
                                         "only_system_specific": "true"}, 84),
        ("SV annotated pathogenic", {}, 1),
    ]
    for name, params, expected in cases:
        r = _apply_filter(svs, name, params)
        assert r.count_passing() == expected, (name, params)

    r = _apply_filter(svs, "SV annotated pathogenic", {"action": "KEEP"},
                      initial=False)
    assert r.count_passing() == 1

    # KEEP on a pre-filtered set (FilterSvFilterColumn_keep)
    svs = _load_svs("SV_Manta_germline.bedpe")
    r = _apply_filter(svs, "SV type", {"Structural variant type": "DEL"})
    assert r.count_passing() == 29
    r = _apply_filter(svs, "SV filter columns",
                      {"entries": "AMBIGUOUS", "action": "KEEP"}, result=r)
    assert r.count_passing() == 42

    multi = _load_svs("SV_Manta_germline_multi.bedpe")
    for name, params, expected in [
            ("SV genotype affected", {"genotypes": "hom"}, 6),
            ("SV genotype control", {"genotypes": "het,wt"}, 10),
            ("SV paired read AF", {"Paired Read AF": "0.13"}, 2),
            ("SV paired read AF", {"Paired Read AF": "0.13",
                                   "only_affected": "true"}, 2),
            ("SV split read AF", {"Split Read AF": "0.55"}, 2),
            ("SV split read AF", {"Split Read AF": "0.55",
                                  "only_affected": "true"}, 4),
            ("SV PE read depth", {"PE Read Depth": "20"}, 2),
            ("SV PE read depth", {"PE Read Depth": "20",
                                  "only_affected": "true"}, 3)]:
        r = _apply_filter(multi, name, params)
        assert r.count_passing() == expected, (name, params)

    som = _load_svs("SV_Manta_somatic.bedpe")
    assert _apply_filter(som, "SV SomaticScore",
                         {"Somaticscore": "60"}).count_passing() == 4

    sniffles = _load_svs("SV_Sniffles_germline.bedpe")
    assert _apply_filter(sniffles, "SV-lr AF",
                         {"min_af": "0.2", "max_af": "0.4"}).count_passing() == 15
    assert _apply_filter(sniffles, "SV-lr support reads", {}).count_passing() == 73
    assert _apply_filter(sniffles, "SV-lr support reads",
                         {"min_support": "15"}).count_passing() == 32


def test_fc_sv_trio():
    """FilterCascade_Test.cpp:1923-1948."""
    trio = _load_svs("SV_Manta_germline_trio.bedpe")
    for types, expected in [("de-novo", 10), ("recessive", 10),
                            ("imprinting", 5)]:
        r = _apply_filter(trio, "SV trio",
                          {"gender_child": "female", "types": types})
        assert r.count_passing() == expected, types


def test_fc_sv_default_cascades():
    """FilterCascade_Test.cpp:2013-2034."""
    from ngsbits_tpu.filters.cascade import FilterCascade

    germline = FilterCascade.load_from_file(f"{DIN}/SV_filters.ini", "germline")
    svs = _load_svs("SV_Manta_germline.bedpe")
    assert germline.apply(svs, "sv", True).count_passing() == 74

    somatic = FilterCascade.load_from_file(f"{DIN}/SV_filters.ini", "somatic")
    som = _load_svs("SV_Manta_somatic.bedpe")
    assert somatic.apply(som, "sv", True).count_passing() == 8


def test_fc_store_and_load_round_trip(tmp_path):
    """FilterCascade_Test.cpp:2036-2054 (store_and_load)."""
    from ngsbits_tpu.filters.cascade import (FilterCascade, create_filter,
                                             filter_names)

    for name in filter_names():
        cascade = FilterCascade()
        cascade.add(create_filter(name))
        text = cascade.to_text()
        cascade2 = FilterCascade.from_text(text)
        assert cascade2.to_text() == text, name


def test_fc_load_bug_empty_enum():
    """FilterCascade_Test.cpp:2056-2064 (load_bug_empty_enum)."""
    from ngsbits_tpu.filters.cascade import FilterCascade

    vl = _load_gsvar("VariantFilter_in.GSvar")
    with open(f"{DIN}/FilterCascade_bug_empty_enum.txt") as fh:
        cascade = FilterCascade.from_text(fh.read().splitlines())
    cascade.apply(vl, "snv", True)


# ---- Graph_Test.cpp / PipelineSettings_Test.cpp / QcRuleMatcher_Test.cpp ---


def _build_graph(directed):
    from ngsbits_tpu.core.graph import TypedGraph

    g = TypedGraph(directed)
    for i in range(1, 21):
        assert g.add_node(str(i), i % 4)
    for i in range(1, 21):
        if i < 20:
            assert g.add_edge(g.get_node(str(i)), g.get_node(str(i + 1)), 1)
            if i < 19 and i % 2 == 1:
                assert g.add_edge(g.get_node(str(i)), g.get_node(str(i + 2)), 3)
            elif i == 19:
                assert g.add_edge(g.get_node("19"), g.get_node("1"), 3)
        else:
            assert g.add_edge(g.get_node("20"), g.get_node("1"), 1)

    with pytest.raises(ValueError):
        g.add_node("1", 2)
    assert not g.add_node("1", 2, False)
    assert not g.add_edge("3", 3, "4", 0, 1)
    assert not g.add_edge(g.get_node("11"), g.get_node("13"), 3)

    assert g.add_edge("2", 2, "21", 1, 2)
    assert g.add_edge("22", 2, "23", 3, 1)
    assert g.add_edge("1", 1, "11", 3, 10)
    assert g.add_edge("20", 0, "22", 2, 1)

    assert g.has_node("4")
    assert g.has_node("23")
    assert not g.has_node("24")
    assert g.get_node("16").node_name() == "16"
    with pytest.raises(ValueError):
        g.get_node("99")
    return g


def test_graph_undirected():
    """Graph_Test.cpp:22-144 (testUndirectedGraph)."""
    g = _build_graph(False)
    assert not g.directed()

    assert g.has_edge("15", "17")
    assert g.has_edge("17", "15")
    assert not g.has_edge("14", "16")
    assert not g.has_edge("16", "14")
    assert not g.has_edge("20", "24")
    assert g.get_edge("1", "11") is g.get_edge("11", "1")
    with pytest.raises(ValueError):
        g.get_edge("99", "20")
    with pytest.raises(ValueError):
        g.get_edge("2", "4")

    assert g.get_node("5").node_content() == 1
    assert g.get_node("16").node_content() == 0
    assert g.get_edge("1", "11").edge_content() == 10
    assert g.get_edge("11", "9").edge_content() == 3

    assert g.is_adjacent("1", "11")
    assert g.is_adjacent("11", "1")
    assert g.is_adjacent("5", "7")
    assert g.is_adjacent("7", "5")
    assert not g.is_adjacent("8", "10")
    with pytest.raises(ValueError):
        g.is_adjacent("99", "20")

    for i in range(1, 24):
        if i % 2 == 0:
            expected = 3 if i in (2, 20) else 2
        else:
            expected = {1: 5, 11: 5, 21: 1, 23: 1}.get(i, 4)
        assert g.get_degree(str(i)) == expected, i


def test_graph_directed():
    """Graph_Test.cpp:146-260 (testDirectedGraph)."""
    g = _build_graph(True)
    assert g.directed()

    assert g.has_edge("15", "17")
    assert not g.has_edge("17", "15")
    assert not g.has_edge("14", "16")
    assert not g.has_edge("16", "14")
    assert not g.has_edge("20", "24")
    with pytest.raises(ValueError):
        g.get_edge("99", "20")
    with pytest.raises(ValueError):
        g.get_edge("2", "4")
    with pytest.raises(ValueError):
        g.get_edge("2", "1")

    assert g.get_node("5").node_content() == 1
    assert g.get_node("16").node_content() == 0
    assert g.get_edge("1", "11").edge_content() == 10
    assert g.get_edge("9", "11").edge_content() == 3

    assert g.is_adjacent("1", "11")
    assert not g.is_adjacent("11", "1")
    assert g.is_adjacent("5", "7")
    assert not g.is_adjacent("7", "5")
    assert not g.is_adjacent("8", "10")


def test_pipeline_settings():
    """PipelineSettings_Test.cpp:9-30 (loadSettings)."""
    from ngsbits_tpu.core.pipeline_settings import PipelineSettings

    PipelineSettings.load_settings(f"{DIN}/megSAP_settings.ini")
    assert PipelineSettings.is_initialized()
    assert PipelineSettings.root_dir() != ""
    assert PipelineSettings.project_folder("diagnostic") == \
        "/mnt/storage4/projects/diagnostic/"
    assert PipelineSettings.project_folder("research") == \
        "/mnt/storage4/projects/research/"
    assert PipelineSettings.project_folder("test") == \
        "/mnt/storage4/projects/test/"
    assert PipelineSettings.project_folder("external") == \
        "/mnt/storage4/projects/external/"
    assert PipelineSettings.data_folder() == "/mnt/storage4/megSAP/data/"
    assert "default_srv010" in PipelineSettings.queues_default()
    assert "research_srv011" in PipelineSettings.queues_research()
    assert "priority_srv010" in PipelineSettings.queues_high_priority()
    assert "highmem_srv010" in PipelineSettings.queues_high_memory()
    assert PipelineSettings.queues_dragen()[0] == "dragen_srv016"


def test_qc_rule_matcher():
    """QcRuleMatcher_Test.cpp:10-80 (checkEvaluation)."""
    from ngsbits_tpu.core.qc_rules import QcRuleMatcher
    from ngsbits_tpu.core.qcml import QCValue

    with pytest.raises(Exception):
        QcRuleMatcher(f"{DIN}/test_qc_cutoffs_invalid.xml")
    m = QcRuleMatcher(f"{DIN}/test_qc_cutoffs.xml")

    name_short, sys_type = "system", "WGS"

    def qc(*pairs):
        return [QCValue.from_double(n, v, "", a) for n, v, a in pairs]

    assert m.evaluate(qc(("target region 20x percentage", 20.0, "QC:2000027"),
                         ("target region read depth", 30.0, "QC:2000025")),
                      name_short, sys_type, False) == "bad"
    assert m.evaluate(qc(("target region 20x percentage", 98.0, "QC:2000027"),
                         ("target region read depth", 30.0, "QC:2000025")),
                      name_short, sys_type, False) == "medium"
    assert m.evaluate(qc(("target region 20x percentage", 99.0, "QC:2000027"),
                         ("target region read depth", 31.0, "QC:2000025")),
                      name_short, sys_type, False) == "good"
    assert m.evaluate(qc(("target region 20x percentage", 99.0, "QC:2000027"),
                         ("target region read depth", 31.0, "QC:2000025"),
                         ("mapped read percentage", 96.0, "QC:2000020")),
                      name_short, sys_type, False) == "good"
    assert m.evaluate(qc(("target region 20x percentage", 99.0, "QC:2000027")),
                      name_short, sys_type, False) == "n/a"
    assert m.evaluate(qc(("insert size", 363.22, "QC:2000023"),
                         ("duplicate read percentage", 11.66, "QC:2000024")),
                      name_short, sys_type, False) == "n/a"

    assert m.evaluate_term("target region 20x percentage", 99.0, name_short,
                           sys_type, False) == "good"
    assert m.evaluate_term("target region 20x percentage", 95.0, name_short,
                           sys_type, False) == "medium"
    assert m.evaluate_term("target region 20x percentage", 89.0, name_short,
                           sys_type, False) == "bad"

    name_short = "RPGR-Ex15"
    assert m.evaluate_term("target region read depth", 1100.0, name_short,
                           sys_type, False) == "good"
    assert m.evaluate_term("target region read depth", 450.0, name_short,
                           sys_type, False) == "medium"


# ---- RepeatLocusList_Test.cpp ----------------------------------------------


def test_repeat_locus_expansionhunter():
    """RepeatLocusList_Test.cpp:8-17 (base_tests_ExpansionHunter)."""
    from ngsbits_tpu.io.repeat_locus import RepeatLocusList

    res = RepeatLocusList.load(f"{DIN}/RepeatLocusList_ExpansionHunter.vcf")
    assert res.caller_as_string() == "ExpansionHunter"
    assert res.caller_version == b"v5.0.0"
    assert res.call_date == "2024-04-16"
    assert len(res) == 84


def test_repeat_locus_straglr():
    """RepeatLocusList_Test.cpp:20-42 (base_tests_Straglr)."""
    from ngsbits_tpu.io.repeat_locus import RepeatLocusList

    res = RepeatLocusList.load(f"{DIN}/RepeatLocusList_Straglr.vcf")
    assert res.caller_as_string() == "Straglr"
    assert res.caller_version == b"V1.5.0"
    assert res.call_date == "2024-06-12"
    assert len(res) == 30

    rl = res[0]
    assert rl.allele1 == b"12.6"
    assert rl.allele2 == b"12.6"
    assert rl.alleles() == b"12.6/12.6"
    assert rl.confidence_intervals == b"7.0-16.7/7.0-16.7"
    assert rl.coverage == b"87"
    assert rl.filters == []
    assert rl.gene_symbol() == b"GLS"
    assert rl.name == b"GLS"
    assert b",".join(rl.overlapping_insertions) == b"37.6 (het)"
    assert rl.ref_size == 7


def test_repeat_locus_find_match():
    """RepeatLocusList_Test.cpp:45-61 (findMatch)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedLine
    from ngsbits_tpu.io.repeat_locus import RepeatLocus, RepeatLocusList

    res = RepeatLocusList.load(f"{DIN}/RepeatLocusList_findMatch.vcf")
    rl = RepeatLocus()
    rl.set_region(BedLine(Chromosome("chr4"), 3074876, 3074933))
    rl.unit = b"CAG"
    rl.set_allele1(b"34.4")
    rl.set_allele2(b"17.2")
    assert res.find_match(rl, False) == 3
    rl.allele1 = b""
    rl.set_allele1(b"35")
    assert res.find_match(rl, False) == -1
    assert res.find_match(rl, True) == 3


# ---- BigWigReader_Test.cpp -------------------------------------------------


def test_bigwig_read_local_values():
    """BigWigReader_Test.cpp:14-115 (read_local_values)."""
    from ngsbits_tpu.io.bigwig import BigWigError, BigWigReader

    r = BigWigReader(f"{DIN}/BigWigReader.bw")
    h = r.header
    assert h.version == 4
    assert h.zoom_levels == 1
    assert h.chromosome_tree_offset == 0x158
    assert h.full_data_offset == 0x190
    assert h.full_index_offset == 0x1E7
    assert h.auto_sql_offset == 0x0
    assert h.total_summary_offset == 0x130
    assert h.uncompress_buf_size == 32768

    s = r.summary
    assert s.bases_covered == 154
    assert s.min_val == pytest.approx(0.1)
    assert s.max_val == pytest.approx(2.0)
    assert s.sum_data == pytest.approx(272.1, abs=1e-6)
    assert s.sum_squares == pytest.approx(500.389992, abs=1e-6)

    with pytest.raises(BigWigError):
        r.read_value("chr1", 0, 0)
    with pytest.raises(BigWigError):
        r.read_values("chr1", 100, 150, 0)
    with pytest.raises(BigWigError):
        r.read_values_region("chr1:0-1", 0)

    r.set_default_value(-50)
    assert r.default_value == -50

    assert r.read_value("chr1", 0, 0) == pytest.approx(0.1, abs=1e-6)
    assert r.read_value("chr1", 1, 0) == pytest.approx(0.2, abs=1e-6)
    assert r.read_value("chr1", 100, 0) == pytest.approx(1.4, abs=1e-6)
    assert r.read_value("chr1", 99, 0) == pytest.approx(r.default_value)

    vals = r.read_values("chr1", 100, 150, 0)
    assert len(vals) == 50
    assert all(v == pytest.approx(1.4, abs=1e-6) for v in vals)

    vals = r.read_values_region("chr1:100-110", 0)
    assert len(vals) == 10
    assert all(v == pytest.approx(1.4, abs=1e-6) for v in vals)

    vals = r.read_values("chr1", 80, 90, 0)
    assert len(vals) == 10
    assert all(v == pytest.approx(r.default_value) for v in vals)

    vals = r.read_values("chr1", 90, 110, 0)
    assert len(vals) == 20
    for i, v in enumerate(vals):
        expected = r.default_value if i < 10 else 1.4
        assert v == pytest.approx(expected, abs=1e-6), i

    r.set_default_value(-42)
    assert r.default_value == -42
    vals = r.read_values("chr1", 80, 90, 0)
    assert len(vals) == 10
    assert all(v == pytest.approx(-42) for v in vals)
    assert r.read_value("chr1", 50, 0) == pytest.approx(-42)


def test_bigwig_read_local_intervals():
    """BigWigReader_Test.cpp:117-155 (read_local_intervals)."""
    from ngsbits_tpu.io.bigwig import BigWigReader

    r = BigWigReader(f"{DIN}/BigWigReader.bw")
    iv = r.get_overlapping_intervals("chr1", 0, 1, 0)
    assert len(iv) == 1
    assert (iv[0][0], iv[0][1]) == (0, 1)
    assert iv[0][2] == pytest.approx(0.1, abs=1e-6)

    iv = r.get_overlapping_intervals("chr1", 1, 2, 0)
    assert len(iv) == 1
    assert (iv[0][0], iv[0][1]) == (1, 2)
    assert iv[0][2] == pytest.approx(0.2, abs=1e-6)

    assert len(r.get_overlapping_intervals("chr1", 0, 3, 0)) == 3

    iv = r.get_overlapping_intervals("chr1", 100, 101, 0)
    assert len(iv) == 1
    assert (iv[0][0], iv[0][1]) == (100, 150)
    assert iv[0][2] == pytest.approx(1.4, abs=1e-6)

    assert len(r.get_overlapping_intervals("chr1", 99, 100, 0)) == 0


# ---- BamReader_Test.cpp / BamWriter_Test.cpp (fixture-available parts) -----


def test_bam_reader_build():
    """BamReader_Test.cpp:167-174 (BamReader_build) — panel.bam part gated
    (stripped blob); insert-only fixture pins hg19."""
    from ngsbits_tpu.io.bam import BamReader

    reader = BamReader(f"{DIN}/BamReader_insert_only.bam")
    assert reader.build_from_chr1() == "hg19"
    reader.close()


def test_bam_reader_pileup_rna():
    """BamReader_Test.cpp:256-274 (BamReader_getPileup_RNA, SNP + no-coverage
    parts; the indel-window part is covered by the CLI pileup goldens)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.qc.pileup import pileup_at_positions

    c10 = Chromosome("chr10").num
    r = pileup_at_positions(f"{DIN}/BamReader_rna.bam", np.array([c10]),
                            np.array([90974727]), min_mapq=1, min_baseq=13)
    assert int(r.depth(True)[0]) == 132
    freq = float(r.frequency(np.array([0]), np.array([1]))[0])  # A -> C
    assert freq == pytest.approx(0.4621, abs=0.001)

    c11 = Chromosome("chr11").num
    r = pileup_at_positions(f"{DIN}/BamReader_rna.bam", np.array([c11]),
                            np.array([92675295]))
    assert int(r.depth(True)[0]) == 0


def test_bam_reader_pileup_insert_only():
    """BamReader_Test.cpp:278-292 (BamReader_getPileup_insert_only)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.qc.pileup import pileup_at_positions

    c19 = Chromosome("chr19").num
    r = pileup_at_positions(f"{DIN}/BamReader_insert_only.bam",
                            np.array([c19, c19]),
                            np.array([5787214, 5787215]),
                            min_mapq=1, min_baseq=13)
    assert r.depth(True).tolist() == [111, 118]
    assert float(r.frequency(np.array([3]), np.array([1]))[0]) == \
        pytest.approx(0.556, abs=0.001)  # T -> C
    assert float(r.frequency(np.array([2]), np.array([0]))[1]) == \
        pytest.approx(0.389, abs=0.001)  # G -> A


def test_bam_info():
    """BamReader_Test.cpp:632-662 (info_bam) — via the BamInfo tool columns."""
    import os
    import subprocess
    import sys

    p = subprocess.run(
        [sys.executable, "-m", "ngsbits_tpu", "BamInfo", "-name", "-in",
         f"{DIN}/BamReader_lr.bam", f"{DIN}/BamReader_rna.bam"],
        capture_output=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    rows = [l.split("\t") for l in p.stdout.decode().splitlines()[1:]]
    # long-read DNA, HG38, masked, no ALT, minimap2, single-end
    assert rows[0] == ["BamReader_lr.bam", "BAM", "hg38", "yes", "no",
                      "minimap2 2.26-r1175", "no"]
    # short-read RNA, HG19, masked, with ALT, STAR (version minus prefix)
    assert rows[1] == ["BamReader_rna.bam", "BAM", "hg19", "yes", "yes",
                      "STAR 2.3.0e_r291", "yes"]


def test_bam_writer_round_trip(tmp_path):
    """BamWriter_Test.cpp:6-53 (write_bam_test) — first alignment written to a
    new BAM replays with the identical CIGAR."""
    from ngsbits_tpu.io.bam import (BamReader, BamRecord, BamWriter,
                                    write_record)

    reader = BamReader(f"{DIN}/bamWriterTest.bam")
    batch = reader.read_batch(1)
    original = BamRecord.from_batch(batch, 0)
    cigar = original.cigar_string()

    out = str(tmp_path / "bamWriterTest.bam")
    writer = BamWriter(out, reader)
    write_record(writer, original)
    writer.close()
    reader.close()

    new_reader = BamReader(out)
    new_batch = new_reader.read_batch(1)
    assert BamRecord.from_batch(new_batch, 0).cigar_string() == cigar
    new_reader.close()


# ---- VariantScores_Test.cpp ------------------------------------------------


def test_variant_scores_algorithms():
    """VariantScores_Test.cpp:9-20 (algorithms/description)."""
    from ngsbits_tpu.core import variant_scores

    assert len(variant_scores.ALGORITHMS) >= 1
    for algorithm in variant_scores.ALGORITHMS:
        assert variant_scores.description(algorithm) != ""


def _score_variants(use_ngsd_classifications):
    from ngsbits_tpu.core import variant_scores
    from ngsbits_tpu.core.intervals import BedFile
    from ngsbits_tpu.io.gsvar import GSvarFile

    roi = BedFile.from_file(f"{DIN}/VariantScores_HP0003002.bed")
    vl = GSvarFile.from_file(f"{DIN}/VariantScores_in1.GSvar")
    params = variant_scores.Parameters()
    params.use_ngsd_classifications = use_ngsd_classifications
    result = variant_scores.score("GSvar_v1", vl, {"HP0003002": roi}, params)
    return vl, result


def test_variant_scores_rank_gsvar_v1():
    """VariantScores_Test.cpp:22-110 (rank_GSvar_v1)."""
    vl, result = _score_variants(True)
    assert result.algorithm == "GSvar_v1"
    assert len(result.scores) == len(vl)
    assert len(result.score_explanations) == len(vl)
    assert len(result.ranks) == len(vl)
    assert len(result.warnings) == 0

    pinned = {
        "chr2:178740622-178740622 A>C": (6.5, 1),
        "chr9:116958287-116958287 C>T": (6.5, 2),
        "chr2:29455199-29455199 A>T": (6.0, 3),
        "chr11:6638385-6638385 C>T": (6.0, 4),
        "chr16:3639230-3639230 G>A": (6.0, 5),
        "chr5:131925483-131925483 G>C": (5.5, 6),
    }
    pinned_scores = {
        "chr2:234737380-234737380 G>T": 2.0,
        "chr14:106330070-106330070 G>A": 1.0,
        "chr7:100806448-100806448 C>G": 1.0,
        "chr1:866511-866511 ->CCCT": -1.0,
    }
    seen = 0
    for i, v in enumerate(vl.variants):
        s = v.to_string()
        if s in pinned:
            assert (result.scores[i], result.ranks[i]) == pinned[s], s
            seen += 1
        if s in pinned_scores:
            assert result.scores[i] == pinned_scores[s], s
    assert seen == len(pinned)

    # score explanation sum equals the score
    for i, score in enumerate(result.scores):
        if score >= 0:
            total = sum(float((e + ":").split(":")[1])
                        for e in result.score_explanations[i])
            assert total == pytest.approx(score), vl[i].to_string()


def test_variant_scores_rank_gsvar_v1_no_ngsd():
    """VariantScores_Test.cpp:112-170 (rank_GSvar_v1_noNGSD)."""
    vl, result = _score_variants(False)
    assert len(result.warnings) == 0
    pinned = {
        "chr9:116958287-116958287 C>T": (6.5, 1),
        "chr2:29455199-29455199 A>T": (6.0, 2),
        "chr2:178740622-178740622 A>C": (6.0, 3),  # no class 4 => -0.5
        "chr11:6638385-6638385 C>T": (6.0, 4),
        "chr16:3639230-3639230 G>A": (6.0, 5),
        "chr5:131925483-131925483 G>C": (5.5, 6),
    }
    seen = 0
    for i, v in enumerate(vl.variants):
        s = v.to_string()
        if s in pinned:
            assert (result.scores[i], result.ranks[i]) == pinned[s], s
            seen += 1
    assert seen == len(pinned)


# ---- remaining ungated methods of already-covered suites -------------------


def test_bedfile_convenience_and_overlaps():
    """BedFile_Test.cpp (convenience_constructor / overlapsWithChrStartEnd /
    overlapsWithLine / overlapsWithFile)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine

    f = BedFile()
    f.append(BedLine(Chromosome("chr1"), 1, 100))
    assert len(f) == 1
    assert f.base_count() == 100

    f = BedFile.from_text("chr1\t0\t99\n\nchr2\t0\t99")
    assert not f.overlaps_with(Chromosome("chr3"), 1, 100)
    assert f.overlaps_with(Chromosome("chr1"), 1, 20)
    assert f.overlaps_with(Chromosome("chr2"), 50, 150)

    line = BedLine(Chromosome("chr1"), 1, 20)
    assert f.overlaps_with(line.chr, line.start, line.end)

    f2 = BedFile.from_text("chr3\t1\t12\n\nchr4\t0\t99")
    assert not f.overlaps_with_file(f2)
    f2 = BedFile.from_text("chr1\t1\t12\n\nchr3\t0\t99")
    assert f.overlaps_with_file(f2)
    f2 = BedFile.from_text("chr1\t200\t212\n\nchr1\t0\t99")
    assert f.overlaps_with_file(f2)
    f2 = BedFile.from_text("chr3\t0\t99\nchr1\t1\t12\n")
    assert f.overlaps_with_file(f2)
    f2 = BedFile.from_text("chr1\t0\t99\nchr1\t200\t212\n")
    assert f.overlaps_with_file(f2)


def test_bedline_overlaps_adjacent_fromstring():
    """BedLine_Test.cpp (overlapsWith* / adjacentTo* / fromString_toString)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedLine

    line1 = BedLine(Chromosome("chr1"), 5, 10)
    assert not line1.overlaps(Chromosome("chr2"), 5, 10)
    assert not line1.overlaps(Chromosome("chr1"), 1, 4)
    assert not line1.overlaps(Chromosome("chr1"), 11, 20)
    assert line1.overlaps(Chromosome("chr1"), 1, 5)
    assert line1.overlaps(Chromosome("chr1"), 5, 10)
    assert line1.overlaps(Chromosome("chr1"), 6, 8)
    assert line1.overlaps(Chromosome("chr1"), 10, 20)
    assert line1.overlaps(Chromosome("chr1"), 1, 20)

    assert line1.overlaps(None, 5, 10)
    assert not line1.overlaps(None, 1, 4)
    assert not line1.overlaps(None, 11, 20)
    assert line1.overlaps(None, 1, 5)
    assert line1.overlaps(None, 6, 8)
    assert line1.overlaps(None, 10, 20)
    assert line1.overlaps(None, 1, 20)

    assert not line1.adjacent_to("chr2", 1, 4)
    assert not line1.adjacent_to("chr1", 1, 3)
    assert not line1.adjacent_to("chr1", 12, 15)
    assert line1.adjacent_to("chr1", 11, 20)
    assert line1.adjacent_to("chr1", 1, 4)

    assert not line1.adjacent_to(1, 3)
    assert not line1.adjacent_to(12, 15)
    assert line1.adjacent_to(11, 20)
    assert line1.adjacent_to(1, 4)

    for text in ("chr1\t1\t20", "chr15\t3589921\t3699921", "chr1\t1\t20\tGene",
                 "chr1\t1\t20\tGene\ttwo_Anno\tthree,Anno"):
        assert BedLine.from_string(text).to_string_with_annotations() == text


def test_geneset_insert_create_remove():
    """GeneSet_Test.cpp (insert_stream/insert_multi/createFromText separators/
    toStringList/remove_*)."""
    from ngsbits_tpu.core.geneset import GeneSet

    s = GeneSet()
    for g in ("A", "B", "C"):
        s.insert(g)
    assert s.count() == 3
    assert (s[0], s[1], s[2]) == ("A", "B", "C")

    s = GeneSet()
    s.insert("A")
    s.insert("B")
    s2 = GeneSet()
    s2.insert("A")
    s2.insert("C")
    s.insert_all(s2)
    assert s.count() == 3
    assert (s[0], s[1], s[2]) == ("A", "B", "C")

    s = GeneSet.create_from_text("#bla,A,C,B", ",")
    assert s.count() == 3
    assert (s[0], s[1], s[2]) == ("A", "B", "C")
    assert list(s) == ["A", "B", "C"]  # toStringList/toByteArrayList

    s = GeneSet()
    for g in ("A", "B", "C", "D"):
        s.insert(g)
    s.remove("B")
    assert s.count() == 3 and not s.contains("B")
    s.remove_all(["C", "D"])
    assert list(s) == ["A"]


def test_sequence_reverse_complement_and_noise():
    """Sequence_Test.cpp (toReverseComplement / addNoise)."""
    import random

    from ngsbits_tpu.io.fasta import reverse_complement

    assert reverse_complement(b"ACGTN") == b"NACGT"

    # addNoise semantics: error_rate chance per base, substituted base differs
    original = b"ACGTACGTACGTACGT"
    rng = random.Random(0)
    for _ in range(50):
        seq = bytearray(original)
        errors = 0
        for i in range(len(seq)):
            if rng.random() < 0.3:
                new = rng.choice([b for b in b"ACGT" if b != seq[i]])
                seq[i] = new
                errors += 1
        diff = sum(1 for a, b in zip(original, seq) if a != b)
        assert diff == errors


def test_qcvalue_constructors():
    """QCCollection_Test.cpp (QCValue_*_constructor)."""
    from ngsbits_tpu.core.qcml import QCType, QCValue

    v = QCValue.from_string("name", "bla", "desc", "QC:???????")
    assert v.type == QCType.STRING
    assert v.value == "bla"
    assert v.to_string() == "bla"

    v = QCValue.from_double("name", 14.56, "desc", "QC:???????")
    assert v.type == QCType.DOUBLE
    assert v.value == pytest.approx(14.56)
    assert v.to_string() == "14.56"

    v = QCValue.from_int("name", 5147483647, "desc", "QC:???????")
    assert v.type == QCType.INT
    assert v.value == 5147483647
    assert v.to_string() == "5147483647"

    v = QCValue.from_int("name", 4711, "desc", "QC:???????")
    assert v.type == QCType.INT
    assert v.to_string() == "4711"


def test_qccollection_store_to_qcml_golden(tmp_path):
    """QCCollection_Test.cpp (storeToQCML) — byte compare vs data_out minus
    'creation ' lines, like the reference's REMOVE_LINES."""
    import base64
    import re

    from ngsbits_tpu.core.qcml import QCCollection, QCValue

    col = QCCollection()
    col.insert(QCValue.from_int("read count", 4711, "description1", "QC:2000005"))
    col.insert(QCValue.from_string("read length", "bla", "description2", "QC:2000006"))
    col.insert(QCValue.from_double("Q20 read percentage", 47.11, "description3",
                                   "QC:2000007"))
    with open(f"{DIN}/QCCollection_01.png", "rb") as fh:
        png = fh.read()
    col.insert(QCValue.image_from_base64("base distribution plot",
                                         base64.b64encode(png), "some plot",
                                         "QC:2000011"))
    out = str(tmp_path / "QCCollection_qcML_out01.qcML")
    col.store_to_qcml(out, ["bli", "bla", "bluff"], 'some"nasty parameters')

    def strip(path):
        with open(path, "rb") as fh:
            return [l for l in fh.read().splitlines() if b"creation " not in l]

    assert strip(out) == strip(f"{NGS_TEST}/data_out/QCCollection_qcML_out01.qcML")


def test_chromosomal_index_synthetic_grids():
    """ChromosomalIndex_Test.cpp (matchingIndices[Long]_BedFile /
    _VariantList / _VcfFile) — the same synthetic grids and pinned counts;
    the index here is a single template over interval containers."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine, ChromosomalIndex

    # variant-style grid: (p, p+10) for chr1..chr5
    grid = BedFile()
    for c in range(1, 6):
        for p in range(1, 100 * c + 1):
            grid.append(BedLine(Chromosome(f"chr{c}"), p, p + 10))
    idx = ChromosomalIndex(grid)
    assert len(idx.matching_indices(Chromosome("chrX"), 5, 15)) == 0
    assert len(idx.matching_indices(Chromosome("chr1"), 0, 100000)) == 100
    assert len(idx.matching_indices(Chromosome("chr1"), 5, 7)) == 7
    assert len(idx.matching_indices(Chromosome("chr1"), 1, 1)) == 1
    assert len(idx.matching_indices(Chromosome("chr2"), 0, 100000)) == 200
    assert len(idx.matching_indices(Chromosome("chr2"), 1, 5)) == 5
    assert len(idx.matching_indices(Chromosome("chr2"), -10, 5)) == 5
    assert len(idx.matching_indices(Chromosome("chr2"), 200, 205)) == 11
    assert len(idx.matching_indices(Chromosome("chr2"), 500, 505)) == 0

    # bed-style grid (chr1..chr22, every 10th line extended by 10)
    grid = BedFile()
    for c in range(1, 23):
        for p in range(1, 100 * c + 1):
            end = p + 10 if p % 10 == 0 else p
            grid.append(BedLine(Chromosome(f"chr{c}"), p, end))
    idx = ChromosomalIndex(grid)
    assert len(idx.matching_indices(Chromosome("chrX"), 5, 15)) == 0
    assert len(idx.matching_indices(Chromosome("chr1"), 0, 100000)) == 100
    assert len(idx.matching_indices(Chromosome("chr1"), 5, 7)) == 3
    assert len(idx.matching_indices(Chromosome("chr1"), 5, 5)) == 1
    assert len(idx.matching_indices(Chromosome("chr2"), 0, 100000)) == 200
    assert len(idx.matching_indices(Chromosome("chr2"), 1, 5)) == 5
    assert len(idx.matching_indices(Chromosome("chr2"), -10, 5)) == 5
    assert len(idx.matching_indices(Chromosome("chr2"), 200, 205)) == 2
    assert len(idx.matching_indices(Chromosome("chr2"), 500, 505)) == 0


def test_ngshelper_known_variants():
    """NGSHelper_Test.cpp (getKnownVariants / getKnownVariants_hg38)."""
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.core.intervals import BedFile, BedLine
    from ngsbits_tpu.core.resources import known_variants

    assert len(known_variants("hg19", False)) == 102467
    assert len(known_variants("hg19", True)) == 97469
    assert len(known_variants("hg19", True, 0.0, 0.8)) == 91186
    assert len(known_variants("hg19", True, 0.2)) == 36022
    assert len(known_variants("hg19", True, 0.2, 0.8)) == 29739
    roi = BedFile()
    roi.append(BedLine(Chromosome("chrX"), 1, 155270560))
    assert len(known_variants("hg19", True, 0.0, 1.0, roi)) == 1948

    assert len(known_variants("hg38", False)) == 100779
    assert len(known_variants("hg38", True, 0.0, 0.5, roi)) == 1548


def test_ngshelper_translate():
    """NGSHelper_Test.cpp (translateCodon[ThreeLetterCode] / translateSequence)."""
    from ngsbits_tpu.core.transcripts import translate_codon, translate_sequence

    one = [("TTG", "L"), ("TCC", "S"), ("TAC", "Y"), ("TGG", "W"),
           ("CAC", "H"), ("CGG", "R"), ("ATG", "M"), ("AAC", "N"),
           ("GTG", "V"), ("GAC", "D"), ("GGG", "G"), ("AGA", "R"),
           ("AGG", "R"), ("ATA", "I"), ("TGA", "*")]
    for codon, aa in one:
        assert translate_codon(codon, False) == aa, codon
    for codon, aa in [("AGA", "*"), ("AGG", "*"), ("ATA", "M"), ("TGA", "W")]:
        assert translate_codon(codon, True) == aa, codon

    seq = b"ATGATATGTCGAGCCGAGGGGAGCTGACCGTAAAGACCC"
    assert translate_sequence(seq, False, False, False) == "MICRAEGS*P*RP"
    assert translate_sequence(seq, False, False, True) == "MICRAEGS*"
    assert translate_sequence(seq, False, True, False) == "MMCRAEGSWP**P"
    assert translate_sequence(seq, False, True, True) == "MMCRAEGSWP*"
    assert translate_sequence(seq, True, False, False) == \
        "MetIleCysArgAlaGluGlySerTerProTerArgPro"
    assert translate_sequence(seq, True, False, True) == \
        "MetIleCysArgAlaGluGlySerTer"
    assert translate_sequence(seq, True, True, False) == \
        "MetMetCysArgAlaGluGlySerTrpProTerTerPro"
    assert translate_sequence(seq, True, True, True) == \
        "MetMetCysArgAlaGluGlySerTrpProTer"


def test_ngshelper_transcript_matches():
    """NGSHelper_Test.cpp (transcriptMatches) — HG19 resource (the HG38 TSV is
    a stripped large blob in this mount)."""
    from ngsbits_tpu.tools.ngsd_export_tools import transcript_matches

    matches = transcript_matches("hg19")
    assert "ENST00000644374" not in matches
    assert "ENST00000004921" in matches
    assert len(matches["ENST00000004921"]) == 2
    assert "CCDS11306" in matches["ENST00000004921"]
    assert "NM_002988" in matches["ENST00000004921"]
    assert "ENST00000004921" in matches["CCDS11306"]
    assert "ENST00000004921" in matches["NM_002988"]


def test_ngshelper_max_entscan_impact():
    """NGSHelper_Test.cpp (maxEntScanImpact) — impact + annotated pairs."""
    from ngsbits_tpu.filters.cascade import max_entscan_impact_annotated

    cases = [
        ([b""], "LOW", b"-"),
        ([b"9.5>8.5"], "LOW", b"9.5>8.5"),
        ([b"9.5>8.2"], "MODERATE", b"9.5>8.2(MODERATE)"),
        ([b"7.1>6.1"], "MODERATE", b"7.1>6.1(MODERATE)"),
        ([b"8.5>6.1"], "HIGH", b"8.5>6.1(HIGH)"),
        ([b"", b"-3.4>4.5", b"2.7>3.3"], "LOW", b"- / -3.4>4.5 / 2.7>3.3"),
        ([b"9.5>8.5", b"-3.4>6.5", b"2.7>6.7"], "MODERATE",
         b"9.5>8.5 / -3.4>6.5(MODERATE) / 2.7>6.7(MODERATE)"),
        ([b"9.5>8.5", b"-3.4>8.7", b"2.7>8.6"], "HIGH",
         b"9.5>8.5 / -3.4>8.7(HIGH) / 2.7>8.6(HIGH)"),
    ]
    for pairs, impact, annotated in cases:
        got_impact, got_annotated = max_entscan_impact_annotated(pairs, False)
        assert got_impact == impact, pairs
        assert got_annotated == annotated, pairs


def test_ngshelper_max_spliceai_score():
    """NGSHelper_Test.cpp (maxSpliceAiScore)."""
    from ngsbits_tpu.ngsd.db import max_spliceai_score

    assert max_spliceai_score(b"") == -1.0
    assert max_spliceai_score(b"0.55") == 0.55
    assert max_spliceai_score(b"BABAM1|0.03|0.00|0.01|0.00|-2|2|41|2") == 0.03
    assert max_spliceai_score(
        b"BABAM1|0.88|0.00|0.01|0.00|-2|2|41|2,"
        b"CTD-2278I10.6|0.99|0.00|0.01|0.00|-2|2|41|2") == 0.99
    assert max_spliceai_score(
        b"BABAM1|0.88|0.00|0.01|0.00|-2|2|41|2,"
        b"CTD-2278I10.6|0.77|0.00|0.01|0.00|-2|2|41|2") == 0.88
    assert max_spliceai_score(
        b"BABAM1|.|.|.|.|-2|2|41|2,CTD-2278I10.6|.|.|.|.|-2|2|41|2") == -1.0


def test_vcffile_store_after_adding_samples(tmp_path):
    """VcfFile_Test.cpp (storeAfterAddingSample / storeAfterAddingThreeSamples)
    — byte-exact vs sort_out2.vcf / sort_out3.vcf."""
    from ngsbits_tpu.io.vcf import VcfFile, vcf_store

    for golden, sample_names in (("sort_out2.vcf", [b"Sample_1"]),
                                 ("sort_out3.vcf", [b"Sample_1", b"Sample_2",
                                                    b"Sample_3"])):
        vl = VcfFile.from_file(f"{DIN}/sort_in.vcf")
        vl.sort()
        # setSampleNames + per-line setFormatKeys/addFormatValues
        vl.column_headers = vl.column_headers[:8] + [b"FORMAT"] + sample_names
        for i in range(len(vl)):
            vl.format_keys[i] = b"CT"
            vl.samples[i] = [str(i).encode()] * len(sample_names)
        out = str(tmp_path / golden)
        vcf_store(vl, out)
        with open(out, "rb") as fh:
            got = fh.read().rstrip(b"\n")
        with open(f"{NGS_TEST}/data_out/{golden}", "rb") as fh:
            assert got == fh.read().rstrip(b"\n"), golden
