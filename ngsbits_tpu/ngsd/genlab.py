"""GenLab LIMS database access layer.

Behavioral reference: ngs-bits cppNGSD/GenLabDB.{h,cpp} (GenLabDB.cpp:1-680).
The reference connects to a Microsoft SQL Server / MySQL instance configured
via settings (genlab_host/genlab_name/genlab_user/genlab_pass) and reads a set
of read-only views (v_ngs_hpo, v_ngs_patient_ids, ...).

Adaptation: the GenLab views are provided as tables of the same
name in a SQLite database whose path is given by the environment variable
``NGSBITS_GENLAB_SQLITE`` (mirrors the settings-based availability gate of
GenLabDB::isAvailable, GenLabDB.cpp:78-86). Production MSSQL access is not
available in this environment.
"""

from __future__ import annotations

import os
import sqlite3

from .db import NGSD, NgsdError


def is_available() -> bool:
    """GenLabDB::isAvailable (GenLabDB.cpp:78-86)."""
    path = os.environ.get("NGSBITS_GENLAB_SQLITE", "")
    return bool(path) and os.path.isfile(path)


class GenLabDB:
    """Read-only access to GenLab views (cppNGSD/GenLabDB.h)."""

    def __init__(self, ngsd: NGSD | None = None):
        if not is_available():
            raise NgsdError("Could not connect to the GenLab database: "
                            "NGSBITS_GENLAB_SQLITE is not set or does not exist")
        self._conn = sqlite3.connect(os.environ["NGSBITS_GENLAB_SQLITE"])
        self._ngsd = ngsd

    def close(self):
        self._conn.close()

    def _values(self, query: str, params=()) -> list:
        cur = self._conn.execute(query, params)
        return [row[0] for row in cur.fetchall()]

    def _rows(self, query: str, params=()) -> list:
        return self._conn.execute(query, params).fetchall()

    @staticmethod
    def names(ps_name: str) -> list[str]:
        """GenLabDB::names (GenLabDB.cpp:668-679) — ps name and sample name."""
        output = [ps_name]
        if "_" in ps_name:
            output.append(ps_name.split("_")[0])
        return output

    # === per-sample meta data ===

    def phenotypes(self, ps_name: str) -> list[tuple[str, str]]:
        """GenLabDB::phenotypes (GenLabDB.cpp:88-146).

        Returns (accession, name) pairs; terms from the 'All', 'Phenotypic
        abnormality', 'Mode of inheritance', 'Frequency' and 'Blood group'
        sub-branches are ignored.
        """
        ngsd = self._ngsd
        if ngsd is None:
            raise NgsdError("GenLabDB.phenotypes requires an NGSD instance")
        ignored: set[int] = set()
        for acc in ("HP:0000001", "HP:0000118"):
            ignored.add(ngsd.phenotype_id_by_accession(acc))
        for parent_acc in ("HP:0000005", "HP:0040279", "HP:0032223"):
            parent = ngsd.phenotype_id_by_accession(parent_acc)
            ignored.add(parent)
            ignored.update(ngsd.phenotype_child_terms(parent, True))

        output: list[tuple[str, str]] = []
        seen: set[str] = set()
        for name in self.names(ps_name):
            for code in self._values("SELECT code FROM v_ngs_hpo WHERE labornummer=?", (name,)):
                hpo_id = (code or "").strip()
                if not hpo_id:
                    continue
                term_id = ngsd.phenotype_id_by_accession(hpo_id, False)
                if term_id == -1 or term_id in ignored:
                    continue
                acc = ngsd.phenotype_accession(term_id)
                if acc in seen:
                    continue
                seen.add(acc)
                output.append((acc, ngsd.phenotype_name(term_id)))
        return output

    def orphanet(self, ps_name: str) -> list[str]:
        """GenLabDB::orphanet (GenLabDB.cpp:148-173)."""
        output = []
        for name in self.names(ps_name):
            for code in self._values("SELECT code FROM v_ngs_orpha WHERE labornummer=?", (name,)):
                orpha = str(code or "").upper().strip()
                if not orpha:
                    continue
                if not orpha.startswith("ORPHA:"):
                    orpha = "ORPHA:" + orpha
                if orpha not in output:
                    output.append(orpha)
        return output

    def diagnosis(self, ps_name: str) -> list[str]:
        """GenLabDB::diagnosis (GenLabDB.cpp:175-194) — ICD10 codes."""
        output = []
        for name in self.names(ps_name):
            for code in self._values("SELECT code FROM v_ngs_icd10 WHERE labornummer=?", (name,)):
                diag = str(code or "").strip()
                if diag and diag not in output:
                    output.append(diag)
        return output

    def anamnesis(self, ps_name: str) -> list[str]:
        """GenLabDB::anamnesis (GenLabDB.cpp:196-217)."""
        output = []
        for name in self.names(ps_name):
            for value in self._values(
                    "SELECT ANAMNESE FROM v_ngs_anamnese WHERE LABORNUMMER=? AND ANAMNESE != 'leer'",
                    (name,)):
                text = str(value or "").replace("\x00", " ").strip()
                if text and text not in output:
                    output.append(text)
        return output

    def tumor_fraction(self, ps_name: str) -> list[str]:
        """GenLabDB::tumorFraction (GenLabDB.cpp:219-239)."""
        output = []
        for name in self.names(ps_name):
            for value in self._values(
                    "SELECT tumoranteil FROM v_ngs_tumoranteil WHERE labornummer=? "
                    "AND tumoranteil IS NOT NULL", (name,)):
                if value is None or float(value) == 0.0:
                    continue
                text = _num_str(value)
                if text not in output:
                    output.append(text)
        return output

    def year_of_birth(self, ps_name: str) -> str:
        """GenLabDB::yearOfBirth (GenLabDB.cpp:241-254)."""
        for name in self.names(ps_name):
            for value in self._values(
                    "SELECT Geburtsjahr FROM v_ngs_dates WHERE LABORNUMMER=? "
                    "AND Geburtsjahr IS NOT NULL", (name,)):
                return str(value)
        return ""

    def sampling_date(self, ps_name: str) -> str:
        """GenLabDB::samplingDate (GenLabDB.cpp:256-269) — yyyy-MM-dd."""
        return self._first_date(ps_name, "Probe_Entnahmedatum")

    def order_entry_date(self, ps_name: str) -> str:
        """GenLabDB::orderEntryDate (GenLabDB.cpp:271-284) — yyyy-MM-dd."""
        return self._first_date(ps_name, "Datum_Auftragseingang")

    def _first_date(self, ps_name: str, column: str) -> str:
        for name in self.names(ps_name):
            for value in self._values(
                    f"SELECT {column} FROM v_ngs_dates WHERE LABORNUMMER=? "
                    f"AND {column} IS NOT NULL", (name,)):
                return str(value)[:10]
        return ""

    def disease_info(self, ps_name: str) -> tuple[str, str]:
        """GenLabDB::diseaseInfo (GenLabDB.cpp:286-329) — (group, status)."""
        group = "n/a"
        status = "n/a"
        for name in self.names(ps_name):
            for g, s in self._rows(
                    "SELECT krankheitsgruppe, patienttyp FROM v_krankheitsgruppe_pattyp "
                    "WHERE labornummer=?", (name,)):
                if g is not None and str(g).strip():
                    group = str(g).strip()
                if s is not None:
                    tmp = str(s).strip()
                    if tmp in ("Index", "Angehöriger betroffen"):
                        status = "Affected"
                    elif tmp == "Angehöriger gesund":
                        status = "Unaffected"
                    elif tmp == "Angehöriger unklar":
                        status = "Unclear"
                if group != "n/a" or status != "n/a":
                    break
        return group, status

    def sap_id(self, ps_name: str) -> str:
        """GenLabDB::sapID (GenLabDB.cpp:332-346)."""
        for name in self.names(ps_name):
            for value in self._values(
                    "SELECT SAPID FROM v_ngs_patient_ids WHERE labornummer=?", (name,)):
                sid = str(value or "").strip()
                if sid:
                    return sid
        return ""

    def relatives(self, ps_name: str) -> list[tuple[str, str, str]]:
        """GenLabDB::relatives (GenLabDB.cpp:377-420).

        Returns (sample1, relation, sample2) with sample1 the relative and
        sample2 the index (both without the processing suffix).
        """
        ngsd = self._ngsd
        if ngsd is None:
            raise NgsdError("GenLabDB.relatives requires an NGSD instance")
        relation_map = {
            "VATER": "parent-child", "MUTTER": "parent-child",
            "VATER (FET)": "parent-child", "MUTTER (FET)": "parent-child",
            "SCHWESTER": "siblings", "BRUDER": "siblings",
            "ZWILLINGSSCHWESTER": "twins", "ZWILLINGSBRUDER": "twins",
            "COUSIN": "cousins", "COUSINE": "cousins",
        }
        output = []
        for name in self.names(ps_name):
            for rel_text, sample2 in self._rows(
                    "SELECT BEZIEHUNGSTEXT, Labornummer_Verwandter FROM v_ngs_duo "
                    "WHERE Labornummer_Index=?", (name,)):
                relation = str(rel_text or "").upper()
                if relation not in relation_map:
                    raise NgsdError(f"Unhandled sample relation '{relation}'!")
                relation = relation_map[relation]
                sample2 = str(sample2 or "")
                if "_" in sample2:
                    sample2 = sample2.split("_")[0]
                # skip if sample is not (yet) contained in NGSD
                if ngsd.sample_id(sample2, False) == "":
                    continue
                sample = ps_name
                if "_" in sample:
                    sample = sample.split("_")[0]
                output.append((sample2, relation, sample))
        return output

    def gender(self, ps_name: str) -> str:
        """GenLabDB::gender (GenLabDB.cpp:422-437) — '1'=female, '2'=male."""
        for name in self.names(ps_name):
            values = self._values(
                "SELECT geschlecht FROM v_ngs_geschlecht WHERE labornummer=?", (name,))
            if values:
                g = str(values[0] or "").strip()
                if g == "1":
                    return "female"
                if g == "2":
                    return "male"
        return ""

    def patient_identifier(self, ps_name: str) -> str:
        """GenLabDB::patientIdentifier (GenLabDB.cpp:439-456)."""
        output = ""
        for name in self.names(ps_name):
            values = self._values(
                "SELECT GenlabID FROM v_ngs_patient_ids WHERE labornummer=?", (name,))
            if values:
                pid = str(values[0] or "").strip()
                if pid:
                    output = pid
        return output

    def studies(self, ps_name: str = "") -> list[str]:
        """GenLabDB::studies (GenLabDB.cpp:458-500) — sorted unique studies."""
        output = []
        if not ps_name:
            values = self._values("SELECT DISTINCT STUDIE FROM v_ngs_studie")
            for v in values:
                study = str(v or "").strip()
                if study and study not in output:
                    output.append(study)
        else:
            for name in self.names(ps_name):
                for v in self._values(
                        "SELECT STUDIE FROM v_ngs_studie WHERE LABORNUMMER=?", (name,)):
                    study = str(v or "").strip()
                    if study and study not in output:
                        output.append(study)
        output.sort()
        return output

    def patient_samples(self, ps_name: str) -> list[str]:
        """GenLabDB::patientSamples (GenLabDB.cpp:540-560) — all samples of the patient."""
        output = []
        for value in self._values(
                "SELECT LABORNUMMER FROM v_ngs_patient_ids WHERE GenlabID=? ORDER BY LABORNUMMER",
                (self.patient_identifier(ps_name),)):
            sample = str(value or "").strip()
            if not sample:
                continue
            if sample[-3:] in ("_01", "_02", "_03", "_04", "_05", "_06"):
                sample = sample[:-3]
            if sample not in output:
                output.append(sample)
        output.sort()
        return output

    def dna_samples_of_rna(self, external_name: str) -> list[str]:
        """GenLabDB::dnaSamplesofRna (GenLabDB.cpp:562-581)."""
        output = []
        for value in self._values(
                "SELECT LABORNUMMER FROM v_ngs_dnarna WHERE T_UNTERSUCHUNG_1_MATERIALINFO=? "
                "ORDER BY LABORNUMMER", (external_name,)):
            sample = str(value or "").strip()
            if sample:
                output.append(sample)
        return output

    def tissue(self, ps_name: str) -> str:
        """GenLabDB::tissue (GenLabDB.cpp:583-601)."""
        tissue_map = {"Wangenschleimhaut": "buccal mucosa", "Paxgene": "blood",
                      "Heparin-Blut": "blood", "Fibroblasten-Kultur": "fibroblast",
                      "EDTA-Blut": "blood"}
        for name in self.names(ps_name):
            for value in self._values(
                    "SELECT PROBENART_LANGFORM FROM v_ngs_eingangsprobe WHERE LABORNUMMER=?",
                    (name,)):
                t = str(value or "").strip()
                if t in tissue_map:
                    return tissue_map[t]
        return ""

    def accounting_data(self, ps_name: str) -> tuple[str, str]:
        """GenLabDB::accountingData (GenLabDB.cpp:603-625) — (company, mode)."""
        company = mode = ""
        for name in self.names(ps_name):
            for c, m in self._rows(
                    "SELECT KASSENNAME, ABRECHNUNGSMODUS FROM v_ngs_abrechnung "
                    "WHERE LABORNUMMER=?", (name,)):
                c = str(c or "").strip()
                m = str(m or "").strip()
                if m == "Undefiniert":
                    m = ""
                if c or m:
                    company, mode = c, m
        return company, mode


def _num_str(v) -> str:
    f = float(v)
    if f == int(f):
        return str(int(f))
    return f"{f:g}"
