"""ExportcBioportal end-to-end test (synthetic study).

The reference tool (src/ExportcBioportal/main.cpp + cppNGSD/ExportCBioPortalStudy.cpp)
has no tools-TEST test; this test builds a complete synthetic setup — NGSD with
a somatic report configuration, sample folders with somatic GSvar/ClinCNV/BEDPE/
fusion files, the mini genome + Ensembl GFF from test_hgvs — and checks every
exported study file.
"""

import pytest

from test_hgvs import _write_mini_gff, _write_mini_ref  # noqa: E402

from helpers import execute  # noqa: E402

DIN = "/root/reference/src/tools-TEST/data_in"


@pytest.fixture
def study_env(tmp_path, monkeypatch):
    monkeypatch.setenv("NGSBITS_NGSD_TEST", str(tmp_path / "ngsd.sqlite"))
    monkeypatch.setenv("NGSBITS_PROJECTS_FOLDER", str(tmp_path / "projects"))
    fa = _write_mini_ref(tmp_path)
    monkeypatch.setenv("NGSBITS_REFERENCE_GENOME", str(fa))

    from ngsbits_tpu.ngsd import NGSD
    db = NGSD(True)
    db.init()
    db.run_mysql_file(f"{DIN}/NGSDImportGenlab_init1.sql")
    # DXtest2 (sample 2, ps 2) = tumor; DXtest1 (sample 1, ps 1) = normal
    db.execute("UPDATE processed_sample SET normal_id=1, comment='good sample' WHERE id=2")
    db.execute("UPDATE sample SET patient_identifier='179159', gender='female' WHERE id=2")
    # RNA sample DXtest4 (sample 4, ps 4) related to the tumor
    db.execute("INSERT INTO sample_relations (sample1_id, relation, sample2_id) VALUES (4, 'same sample', 2)")
    # mini gene + transcripts
    db.execute("INSERT INTO gene (hgnc_id, symbol, name, type) VALUES (1, 'TESTG', 'test gene', 'protein-coding gene')")
    db.commit()
    gff = _write_mini_gff(tmp_path)
    assert execute("NGSDImportEnsembl", ["-test", "-in", gff]) == 0

    # variants (A=stop gained, B=missense/excluded, C=synonymous/unconfigured)
    db.execute("INSERT INTO variant (id, chr, start, end, ref, obs) VALUES "
               "(3001, 'chr1', 156, 156, 'G', 'A'),"
               "(3002, 'chr1', 134, 134, 'G', 'A'),"
               "(3003, 'chr1', 145, 145, 'T', 'A')")
    db.execute("INSERT INTO somatic_vicc_interpretation (variant_id, null_mutation_in_tsg, "
               "known_oncogenic_aa, created_by, created_date) VALUES (3001, 1, 1, 1, '2024-01-01 00:00:00')")
    # QC terms: MSI / HRD / TMB
    db.execute("INSERT INTO qc_terms (qcml_id, name, description, type, obsolete) VALUES "
               "('QC:2000141', 'somatic MSI', '', 'float', 0),"
               "('QC:2000126', 'HRD score', '', 'int', 0),"
               "('QC:2000053', 'somatic variant rate', '', 'float', 0)")
    for qcml_id, value in (("QC:2000141", "5.5"), ("QC:2000126", "3"), ("QC:2000053", "7.8")):
        db.execute("INSERT INTO processed_sample_qc (processed_sample_id, qc_terms_id, value) "
                   "SELECT 2, id, ? FROM qc_terms WHERE qcml_id=?", (value, qcml_id))
    # disease details of the tumor sample
    for info, info_type in (("C34.1", "ICD10 code"), ("HP:0000750", "HPO term id"),
                            ("Lung cancer", "clinical phenotype (free text)"),
                            ("40", "tumor fraction")):
        db.execute("INSERT INTO sample_disease_info (sample_id, disease_info, type, user_id, date) "
                   "VALUES (2, ?, ?, 1, '2024-01-01 00:00:00')", (info, info_type))
    # somatic report configuration
    db.execute("INSERT INTO somatic_report_configuration (id, ps_tumor_id, ps_normal_id, "
               "created_by, created_date) VALUES (1, 2, 1, 1, '2024-01-01 00:00:00')")
    db.execute("INSERT INTO somatic_report_configuration_variant (somatic_report_configuration_id, "
               "variant_id, exclude_artefact, exclude_low_tumor_content, exclude_low_copy_number, "
               "exclude_high_baf_deviation, exclude_other_reason, comment) VALUES "
               "(1, 3001, 0, 0, 0, 0, 0, ''), (1, 3002, 1, 0, 0, 0, 0, 'artefact')")
    # somatic CNV (excluded via report config)
    db.execute("INSERT INTO somatic_cnv_callset (ps_tumor_id, ps_normal_id, caller, "
               "caller_version, call_date) VALUES (2, 1, 'ClinCNV', 'v1.16.1', '2024-01-01')")
    db.execute("INSERT INTO somatic_cnv (id, somatic_cnv_callset_id, chr, start, end, cn, "
               "tumor_cn, tumor_clonality) VALUES (1, 1, 'chr1', 300, 500, 6, 6, 0.9)")
    db.execute("INSERT INTO somatic_report_configuration_cnv (somatic_report_configuration_id, "
               "somatic_cnv_id, exclude_artefact, exclude_low_tumor_content, exclude_low_copy_number, "
               "exclude_high_baf_deviation, exclude_other_reason, comment) VALUES (1, 1, 1, 0, 0, 0, 0, '')")
    # somatic SV (DEL, included)
    db.execute("INSERT INTO somatic_sv_callset (ps_tumor_id, ps_normal_id, caller, caller_version, "
               "call_date) VALUES (2, 1, 'Manta', '1.6.0', '2024-01-01')")
    db.execute("INSERT INTO somatic_sv_deletion (id, somatic_sv_callset_id, chr, start_min, "
               "start_max, end_min, end_max) VALUES (1, 1, 'chr1', 1000, 1020, 5000, 5020)")
    db.execute("INSERT INTO somatic_report_configuration_sv (somatic_report_configuration_id, "
               "somatic_sv_deletion_id, exclude_artefact, exclude_unclear_effect, exclude_other, "
               "description, comment) VALUES (1, 1, 0, 0, 0, '', '')")
    db.commit()
    db.close()

    # === sample folders ===
    project = tmp_path / "projects" / "diagnostic" / "SomaticAndTreatment"
    (project / "Sample_DXtest1_01").mkdir(parents=True)
    (project / "Sample_DXtest2_01").mkdir(parents=True)
    (project / "Sample_DXtest4_01").mkdir(parents=True)
    somatic = project / "Somatic_DXtest2_01-DXtest1_01"
    somatic.mkdir()
    base = somatic / "DXtest2_01-DXtest1_01"

    # germline GSvar (no report-config germline variants)
    (project / "Sample_DXtest1_01" / "DXtest1_01.GSvar").write_text(
        "##ANALYSISTYPE=GERMLINE_SINGLESAMPLE\n"
        "#chr\tstart\tend\tref\tobs\tfilter\tquality\tgene\n")

    # somatic GSvar
    cs = "TESTG:ENST00000000001.1:{t}:{i}:1/3:{c}:{p}:"
    with open(str(base) + ".GSvar", "w") as fh:
        fh.write("##ANALYSISTYPE=SOMATIC_PAIR\n")
        fh.write("#chr\tstart\tend\tref\tobs\ttumor_af\ttumor_dp\tnormal_af\tnormal_dp\t"
                 "filter\tquality\tgene\tvariant_type\tcoding_and_splicing\n")
        fh.write("chr1\t156\t156\tG\tA\t0.25\t100\t0.0\t80\t.\tQUAL=50\tTESTG\tSNV\t"
                 + cs.format(t="stop_gained", i="HIGH", c="c.26G>A", p="p.Trp9Ter") + "\n")
        fh.write("chr1\t134\t134\tG\tA\t0.10\t100\t0.0\t80\t.\t.\tTESTG\tSNV\t"
                 + cs.format(t="missense_variant", i="MODERATE", c="c.4G>A", p="p.Ala2Thr") + "\n")
        fh.write("chr1\t145\t145\tT\tA\t0.33\t90\t0.0\t70\t.\t.\tTESTG\tSNV\t"
                 + cs.format(t="synonymous_variant", i="LOW", c="c.15T>A", p="p.Leu5=") + "\n")

    # ClinCNV file: CNV1 kept (CN 0), CNV2 configured-excluded
    with open(str(base) + "_clincnv.tsv", "w") as fh:
        fh.write("##ANALYSISTYPE=CLINCNV_TUMOR_NORMAL_PAIR\n")
        fh.write("##ploidy: 1.9966\n")
        fh.write("#chr\tstart\tend\tsample\tsize\tnumber_of_regions\ttumor_CN_change\ttumor_clonality\tCN_change\tgenes\n")
        fh.write("chr1\t120\t180\tDXtest2_01-DXtest1_01\t60\t3\t0\t0.775\t0\tGENEA,GENEB\n")
        fh.write("chr1\t300\t500\tDXtest2_01-DXtest1_01\t200\t5\t6\t0.9\t6\tGENEC\n")

    # SV BEDPE
    with open(str(base) + "_var_structural_variants.bedpe", "w") as fh:
        fh.write("##fileformat=BEDPE_TUMOR_NORMAL_PAIR\n")
        fh.write("##ANALYSISTYPE=MANTA_TUMOR_NORMAL_PAIR\n")
        fh.write("#CHROM_A\tSTART_A\tEND_A\tCHROM_B\tSTART_B\tEND_B\tTYPE\tFILTER\t"
                 "SOMATICSCORE\tALT_A\tINFO_A\n")
        fh.write("chr1\t1000\t1020\tchr1\t5000\t5020\tDEL\tPASS\t60\t.\t.\n")

    with open(str(base) + "_msi.tsv", "w") as fh:
        fh.write("")

    # RNA fusions (arriba)
    with open(project / "Sample_DXtest4_01" / "DXtest4_01_fusions_arriba.tsv", "w") as fh:
        fh.write("#gene1\tgene2\tbreakpoint1\tbreakpoint2\ttype\tsplit_reads1\tsplit_reads2\t"
                 "discordant_mates\treading_frame\n")
        fh.write("TESTG\tOTHER\tchr1:150\tchr9:5000\ttranslocation\t3\t4\t7\tout-of-frame\n")

    # === input TSVs ===
    samples = tmp_path / "samples.tsv"
    samples.write_text(
        "#tumor_ps_name\tnormal_ps_name\tsap_id\tmtb_case_id\tmtb_registration_date\t"
        "mtb_board_date\tpatient_mpi\ticd10_code\ticd10_catalog\toncotree_code\n"
        "DXtest2\tDXtest1_01\t4711\tMTB-1\t2024-01-02\t2024-02-03\tMPI1\tC34.1\t10-GM-2024\tLUAD\n")

    study_data = tmp_path / "study.tsv"
    study_data.write_text("\n".join([
        "study_name\tTest Study",
        "study_identifier\ttest_study",
        "study_description\tA test study",
        "study_reference\thg38",
        "cancer_name\tluad",
        "cancer_description\tLung adenocarcinoma",
        "cancer_parent\tlung",
        "cancer_color\tGreen"]) + "\n")

    attrs = tmp_path / "attributes.tsv"
    rows = ["#name\tdb_name\tdescription\tdatatype\tpriority"]
    for db_name in ("SAMPLE_ID", "PATIENT_ID", "GENLAB_PAT_ID", "MSI_STATUS", "PLOIDY",
                    "PURITY_HIST", "PURITY_CNVS", "PROCESSING_SYSTEM", "COMMENT", "HRD_SCORE",
                    "TMB", "ICD10", "HPO_TERMS", "CLINICAL_PHENOTYPE", "MTB_CASE_ID"):
        rows.append(f"{db_name.title().replace('_', ' ')}\t{db_name}\tdesc {db_name}\tSTRING\t1")
    attrs.write_text("\n".join(rows) + "\n")

    return tmp_path


def test_export_cbioportal(study_env):
    tmp_path = study_env
    out = tmp_path / "out"
    assert execute("ExportcBioportal", [
        "-test", "-samples", tmp_path / "samples.tsv", "-study_data", tmp_path / "study.tsv",
        "-attribute_data", tmp_path / "attributes.tsv", "-out", out]) == 0

    study = out / "test_study"

    # meta files (key-sorted)
    assert (study / "meta_study.txt").read_text() == (
        "add_global_case_list: true\n"
        "cancer_study_identifier: test_study\n"
        "description: A test study\n"
        "name: Test Study\n"
        "reference_genome: hg38\n"
        "type_of_cancer: luad\n")
    assert (study / "data_cancer_type.txt").read_text() == \
        "luad\tLung adenocarcinoma\tGreen\tlung\n"

    # patients
    lines = (study / "data_clinical_patients.txt").read_text().splitlines()
    assert lines[4] == "PATIENT_ID\tGENDER\tGENLAB_PAT_ID\tMTB_CASE_ID"
    assert lines[5] == "4711\tfemale\t179159\tMTB-1"
    assert len(lines) == 6

    # samples (all 15 attributes)
    lines = (study / "data_clinical_samples.txt").read_text().splitlines()
    assert lines[4].split("\t")[0] == "SAMPLE_ID"
    values = lines[5].split("\t")
    expected = ["DXtest2_01", "4711", "179159", "kein Hinweis auf MSI", "2.00", "0.40", "0.90",
                "SureSelect Human All Exon v6", "good sample", "3", "7.80", "C34.1",
                "HP:0000750", "Lung cancer", "MTB-1"]
    assert values == expected

    # mutations: variant A (configured, kept) + C (unconfigured); B excluded
    lines = (study / "data_mutations.txt").read_text().splitlines()
    assert lines[0].split("\t")[0] == "Hugo_Symbol"
    assert len(lines) == 3
    assert lines[1].split("\t") == [
        "TESTG", "GRCh37", "chr1", "156", "156", "stop_gained", "G", "A", "DXtest2_01",
        "p.Trp9Ter", "25", "75", "0", "55", "ONCOGENIC"]
    assert lines[2].split("\t") == [
        "TESTG", "GRCh37", "chr1", "145", "145", "synonymous_variant", "T", "A", "DXtest2_01",
        "p.Leu5=", "30", "60", "0", "40", ""]

    # CNVs: only the kept CNV's genes appear, CN 0 -> -2
    lines = (study / "data_CNV.txt").read_text().splitlines()
    assert lines[0] == "Hugo_Symbol\tEntrez_Gene_Id\tDXtest2_01"
    assert lines[1:] == ["GENEA\t-2", "GENEB\t-2"]

    # fusions
    lines = (study / "data_FU.txt").read_text().splitlines()
    assert len(lines) == 2
    assert lines[1].split("\t") == [
        "DXtest2_01", "GRCh38", "SOMATIC", "Event info", "TESTG", "", "", "chr1", "150",
        "OTHER", "", "", "chr9", "5000", "frameshift", "Translocation", "7", "7", "PRECISE"]

    # case lists
    for name, stable in (("cases_sequenced.txt", "_sequenced"), ("cases_cnv.txt", "_cna"),
                         ("cases_sv.txt", "_sv")):
        content = (study / "case_lists" / name).read_text()
        assert f"stable_id: test_study{stable}\n" in content
        assert content.rstrip().endswith("case_list_ids: DXtest2_01")

    # all meta files exist
    for meta in ("meta_cancer_type.txt", "meta_clinical_patients.txt", "meta_clinical_samples.txt",
                 "meta_mutations.txt", "meta_CNV.txt", "meta_FU.txt"):
        assert (study / meta).exists()
