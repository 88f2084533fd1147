"""Pairwise sample-similarity engine.

Behavioral reference: ngs-bits ``SampleSimilarity`` (cppNGS/
SampleSimilarity.cpp): genotype extraction from VCF (GT -> 0/0.5/1),
GSvar (impact-filtered) or BAM (pileup AF at known SNPs with min_cov and
max_snps cap); similarity = overlap count/%, Pearson correlation of genotype
vectors (float32 values), IBS0% (0.9/0.1 thresholds), IBS2%, fallback to
fraction-matching when correlation is NaN.
"""

from __future__ import annotations

import math

import numpy as np

from ..core import resources
from ..core.basicstats import correlation
from ..io.gsvar import GSvarFile
from ..io.vcf import VcfFile
from .pileup import BASE2IDX, pileup_at_positions


def geno_to_double(geno: bytes) -> float:
    if geno == b"hom":
        return 1.0
    if geno == b"het":
        return 0.5
    if geno in (b"1/1", b"1|1"):
        return 1.0
    if geno in (b"0/1", b"0|1", b"./1", b".|1", b"1/0", b"1|0", b"1/.", b"1|."):
        return 0.5
    if geno in (b"0/0", b"0|0", b"./0", b".|0", b"0/.", b"0|.", b".|."):
        return 0.0
    raise ValueError(f"Invalid genotype '{geno.decode(errors='replace')}' in input file.")


def genotypes_from_vcf(filename: str, include_gonosomes: bool, skip_multi: bool,
                       roi=None) -> dict:
    variants = VcfFile.from_file(filename)
    if len(variants.sample_ids()) > 1:
        raise ValueError("The genotype can not be determined correctly for a VCF line "
                         f"with multiple samples. File name:  {filename} .")
    if not variants.header.format_id_defined("GT"):
        raise ValueError(f"Could not determine genotype column for variant list {filename}")

    roi_idx = None
    if roi is not None and len(roi):
        from ..core.intervals import BedFile, ChromosomalIndex
        rs = BedFile()
        rs.lines = sorted(roi.lines, key=lambda l: l.sort_key())
        roi_idx = ChromosomalIndex(rs)

    out: dict = {}
    for i in range(len(variants)):
        v = variants[i]
        if roi_idx is not None and len(roi_idx.matching_indices(v.chr, v.start, v.end)) == 0:
            continue
        if not v.chr.is_autosome() and not include_gonosomes:
            continue
        if v.is_multi_allelic():
            if skip_multi:
                continue
            raise ValueError("Can not handle multiallelic variants.")
        key = f"{v.chr.str}:{v.start} {v.ref.decode()}>{v.alt_string().decode()}"
        out[key] = np.float32(geno_to_double(v.format_value("GT")))
    return out


def genotypes_from_gsvar(filename: str, include_gonosomes: bool, roi=None) -> dict:
    gs = GSvarFile.from_file(filename, roi)
    cols = gs.affected_sample_columns()
    if len(cols) != 1:
        raise ValueError(f"Could not determine genotype column for variant list {filename}")
    geno_col = cols[0]
    i_cons = gs.annotation_index("coding_and_splicing")
    out: dict = {}
    for v in gs.variants:
        if not v.chr.is_autosome() and not include_gonosomes:
            continue
        cons = v.annotations[i_cons]
        if b":HIGH:" not in cons and b":MODERATE:" not in cons and b":LOW:" not in cons:
            continue
        out[v.to_string()] = np.float32(geno_to_double(v.annotations[geno_col]))
    return out


def genotypes_from_bam(build: str, filename: str, min_cov: int, max_snps: int,
                       include_gonosomes: bool, roi=None,
                       include_not_properly_paired: bool = False) -> dict:
    snps = resources.known_variants(build, True, 0.2, 0.8, roi=roi)
    n = len(snps)
    keep = []
    for i in range(n):
        c = snps.chr_of(i)
        if not c.is_autosome() and not include_gonosomes:
            continue
        keep.append(i)
    keep = np.array(keep, dtype=np.int64)
    chr_nums = np.array([snps.chr_of(int(i)).num for i in keep], dtype=np.int64)
    positions = snps.pos[keep]
    res = pileup_at_positions(filename, chr_nums, positions, min_mapq=1,
                              include_not_properly_paired=include_not_properly_paired,
                              min_baseq=13)  # getPileup default (BamReader.h:417)
    depth = res.depth()
    ref_idx = np.array([BASE2IDX.get(snps.refs[int(i)][:1], 0) for i in keep], dtype=np.int64)
    alt_idx = np.array([BASE2IDX.get(snps.alts[int(i)].split(b",")[0][:1], 0) for i in keep], dtype=np.int64)
    freq = res.frequency(ref_idx, alt_idx)

    out: dict = {}
    for k in range(len(keep)):
        if depth[k] < min_cov:
            continue
        if not math.isfinite(freq[k]):
            continue
        i = int(keep[k])
        c = snps.chr_of(i)
        key = (f"{c.str_normalized(False)}:{int(snps.pos[i])} "
               f"{snps.refs[i].decode()}>{snps.alts[i].split(b',')[0].decode()}")
        out[key] = np.float32(freq[k])
        if max_snps > 0 and len(out) >= max_snps:
            break
    return out


class SimilarityResult:
    def __init__(self):
        self.no_variants1 = 0
        self.no_variants2 = 0
        self.sample_correlation = math.nan
        self.ol_perc = math.nan
        self.ol_count = 0
        self.ibs0_perc = math.nan
        self.ibs2_perc = math.nan
        self.messages: list[str] = []


def calculate_similarity(in1: dict, in2: dict) -> SimilarityResult:
    r = SimilarityResult()
    geno1 = []
    geno2 = []
    c_ol = c_ibs2 = c_ibs0 = 0
    for key, f1 in in1.items():
        f2 = in2.get(key)
        if f2 is None:
            continue
        c_ol += 1
        geno1.append(float(f1))
        geno2.append(float(f2))
        if (f1 > 0.9 and f2 > 0.9) or (f1 < 0.1 and f2 < 0.1):
            c_ibs2 += 1
        if (f1 > 0.9 and f2 < 0.1) or (f1 < 0.1 and f2 > 0.9):
            c_ibs0 += 1

    if not geno1:
        r.messages.append("Zero overlap between variant lists!")
        return r

    r.no_variants1 = len(in1)
    r.no_variants2 = len(in2)
    min_count = min(r.no_variants1, r.no_variants2)
    r.ol_perc = 100.0 * c_ol / min_count
    r.ol_count = c_ol
    # device route: exact integer-moment Pearson for discrete genotype sets
    # (VCF/GSvar 0/0.5/1); BAM-mode continuous AFs stay on the float64 host
    # path
    from ..ops import device_reduce as dr
    r.sample_correlation = None
    if dr.use_device():
        import numpy as _np
        g1 = _np.asarray(geno1)
        g2 = _np.asarray(geno2)
        if (_np.array_equal(g1 * 2, _np.rint(g1 * 2))
                and _np.array_equal(g2 * 2, _np.rint(g2 * 2))):
            r.sample_correlation = dr.pearson_from_genotypes(g1, g2)
    if r.sample_correlation is None:
        r.sample_correlation = correlation(geno1, geno2)
    r.ibs2_perc = 100.0 * c_ibs2 / min_count
    r.ibs0_perc = 100.0 * c_ibs0 / min_count

    if not math.isfinite(r.sample_correlation):
        equal = sum(1.0 for a, b in zip(geno1, geno2) if a == b)
        r.sample_correlation = equal / len(geno1)
        r.messages.append("Could not calulate genotype correlation, calculated the fraction of matching genotypes instead.")
    return r
