# Copied from close_kmers_tpu/db/propagate_names.py.
"""Family-release name propagation: renumber a new family release to
match an old release by md5-membership overlap.

Parity with propagate_names.{h,cc}:

* FamData — loads per-genus ``nr/peg.synonyms`` files
  (``gnl|md5|<md5>,<len>\\tfid,len;fid,len;...``, propagate_names.cc:35-108)
  and the 9-column family file keyed by global family or
  ``genus.localnum`` (:155-249).  An md5 keeps its FIRST family
  (insert-no-overwrite); a family's member set is the set of its md5s.
* RenumberState — three phases:
  - phase 1 (:257-399): for each old family, vote over the new families
    its members landed in; if every observed cross-mapping folds back to
    this old family (bad == 0), a single new family inherits the old
    name; multiple new families = a SPLIT (largest keeps the name, the
    rest get NEW_n ids).
  - phase 2 (:401-549): for each still-unnamed new family, if none of
    its members exist in the old release it gets a NEW_n id; if the old
    families it draws from map only to this new family, it's a JOIN and
    takes the name of the largest contributor.
  - phase 3 (:551-620): leftovers — an unused old family gives its name
    to the plurality new family if the overlap fraction > 0.75 and that
    family is still unnamed; sequential by design.
* write_unmapped (:622-650).

Ties in sort-by-count are broken by key ascending (the reference's
std::sort on unordered-map-derived vectors is nondeterministic there).
Log lines match the reference's grammar (``X NOW Y``, ``SPLIT O ... => N
...``, ``JOIN a b => n``).
"""

from __future__ import annotations

import os

LOCAL, GLOBAL = "local", "global"


def sort_by_values(d: dict[str, int]) -> list[tuple[str, int]]:
    return sorted(d.items(), key=lambda kv: (-kv[1], kv[0]))


class FamData:
    def __init__(self, fams_file: str, data_dir: str, target_genus: str = "",
                 family_type: str = GLOBAL):
        self.fams_file = fams_file
        self.data_dir = data_dir
        self.target_genus = target_genus
        self.family_type = family_type
        self.md5_to_key: dict[str, str] = {}
        self.fid_is_key: dict[str, str] = {}
        self.fid_to_md5: dict[str, str] = {}
        self.fam_to_md5s: dict[str, set[str]] = {}
        self.fam_to_function: dict[str, str] = {}
        self.md5_to_fam: dict[str, str] = {}

    # -- peg.synonyms --------------------------------------------------------

    def read_pegsyn_file(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if line[:8] != "gnl|md5|":
                    raise ValueError("Invalid pegsyn line")
                com = line.find(",", 8)
                if com < 0:
                    raise ValueError("Invalid pegsyn line (no comma)")
                tab = line.find("\t", com + 1)
                md5 = line[8:com]
                rest = line[tab + 1:]
                pos = 0
                first = True
                while pos < len(rest):
                    nxt = rest.find(",", pos)
                    if nxt < 0:
                        break
                    fid = rest[pos:nxt]
                    if first:
                        if md5 not in self.md5_to_key:
                            self.md5_to_key[md5] = fid
                            self.fid_is_key[fid] = md5
                        first = False
                    self.fid_to_md5[fid] = md5
                    nxt = rest.find(";", nxt)
                    if nxt < 0:
                        break
                    pos = nxt + 1

    def read_pegsyn(self) -> None:
        """Scan <data_dir>/<genus>/nr/peg.synonyms (propagate_names.cc:110-152)."""
        for genus in sorted(os.listdir(self.data_dir)):
            gpath = os.path.join(self.data_dir, genus)
            if not os.path.isdir(gpath):
                continue
            if self.target_genus and genus != self.target_genus:
                continue
            pegsyn = os.path.join(gpath, "nr", "peg.synonyms")
            if not os.path.isfile(pegsyn):
                raise FileNotFoundError(f"Pegsynfile {pegsyn} does not exist")
            self.read_pegsyn_file(pegsyn)

    # -- family file ---------------------------------------------------------

    def read_fams_file(self) -> None:
        last_fam = None
        with open(self.fams_file) as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 9:
                    continue
                peg = cols[3]
                md5 = self.fid_to_md5.get(peg)
                if md5 is None:
                    continue
                fam = cols[0] if self.family_type == GLOBAL \
                    else cols[7] + "." + cols[6]
                if fam != last_fam:
                    self.fam_to_function.setdefault(fam, cols[5])
                    last_fam = fam
                self.md5_to_fam.setdefault(md5, fam)
                self.fam_to_md5s.setdefault(fam, set()).add(md5)

    def exists(self, md5: str) -> bool:
        return md5 in self.md5_to_key

    def peg_to_fam(self, md5: str) -> str:
        return self.md5_to_fam.get(md5, "")

    def fam_to_fun(self, fam: str) -> str:
        return self.fam_to_function.get(fam, "")


class RenumberState:
    def __init__(self, old_data: FamData, new_data: FamData):
        self.old = old_data
        self.new = new_data
        self.results: list[str] = []
        self.old_fam_to_new_fam_set: dict[str, set[str]] = {}
        self.old_fam_used: dict[str, str] = {}
        self.new_fam_name: dict[str, str] = {}
        self.new_idx = 1

    def log_result(self, res: str) -> None:
        self.results.append(res)

    def allocate_new_id(self) -> str:
        nm = f"NEW_{self.new_idx}"
        self.new_idx += 1
        return nm

    # -- phase 1 -------------------------------------------------------------

    def phase_1(self) -> None:
        for fam in sorted(self.old.fam_to_md5s):
            self._phase_1_body(fam, self.old.fam_to_md5s[fam])

    def _phase_1_body(self, fam: str, fids: set[str]) -> None:
        nfam_checked: set[str] = set()
        nfam_count: dict[str, int] = {}
        bad = 0
        for peg in sorted(fids):
            if not self.new.exists(peg):
                continue
            nfam = self.new.peg_to_fam(peg)
            if nfam in nfam_checked:
                continue
            nfam_checked.add(nfam)
            for npeg in sorted(self.new.fam_to_md5s.get(nfam, ())):
                if self.old.exists(npeg):
                    if self.old.peg_to_fam(npeg) == fam:
                        nfam_count[nfam] = nfam_count.get(nfam, 0) + 1
                    else:
                        bad += 1
                        if bad > 10:
                            break
        self.old_fam_to_new_fam_set[fam] = nfam_checked
        if bad:
            return
        if len(nfam_count) == 1:
            nfam = next(iter(nfam_count))
            self.log_result(f"{nfam} NOW {fam}\n")
            self.new_fam_name[nfam] = fam
            self.old_fam_used[fam] = nfam
        elif len(nfam_count) > 1:
            vec = sort_by_values(nfam_count)
            self.log_result("SPLIT O " + fam + " => N "
                            + " ".join(x[0] for x in vec) + "\n")
            nfam = vec[0][0]
            self.new_fam_name[nfam] = fam
            self.old_fam_used[fam] = nfam
            self.log_result(f"{nfam} NOW {fam}\n")
            for nf, _cnt in vec[1:]:
                nm = self.allocate_new_id()
                self.new_fam_name[nf] = nm
                self.log_result(f"{nf} NOW {nm}\n")

    # -- phase 2 -------------------------------------------------------------

    def phase_2(self) -> None:
        for nfam in sorted(self.new.fam_to_md5s):
            self._phase_2_body(nfam, self.new.fam_to_md5s[nfam])

    def _phase_2_body(self, nfam: str, nfids: set[str]) -> None:
        if nfam in self.new_fam_name:
            return
        npegs_that_exist = [f for f in sorted(nfids) if self.old.exists(f)]
        if not npegs_that_exist:
            nm = self.allocate_new_id()
            self.new_fam_name[nfam] = nm
            self.log_result(f"{nfam} NOW {nm}\n")
            return
        mapped_nfams: dict[str, int] = {}
        ocount: dict[str, int] = {}
        for npeg in npegs_that_exist:
            ofam = self.old.md5_to_fam.get(npeg)
            if ofam is None:
                continue
            if ocount.get(ofam, 0) == 0:
                for mapped in self.old_fam_to_new_fam_set.get(ofam, ()):
                    mapped_nfams[mapped] = mapped_nfams.get(mapped, 0) + 1
            ocount[ofam] = ocount.get(ofam, 0) + 1
        if len(mapped_nfams) == 1:
            ocount_sorted = sort_by_values(ocount)
            rest = " ".join(x[0] for x in ocount_sorted)
            oname = ocount_sorted[0][0]
            self.new_fam_name[nfam] = oname
            self.old_fam_used[oname] = nfam
            self.log_result(f"{nfam} NOW {oname}\n")
            self.log_result(f"JOIN {rest} => {nfam}\n")

    # -- phase 3 -------------------------------------------------------------

    def phase_3(self) -> None:
        for fam in sorted(self.old.fam_to_md5s):
            self._phase_3_body(fam, self.old.fam_to_md5s[fam])

    def _phase_3_body(self, fam: str, fids: set[str]) -> None:
        if fam in self.old_fam_used:
            return
        nfams: dict[str, int] = {}
        n = 0
        for fid in sorted(fids):
            if not self.new.exists(fid):
                continue
            nfam = self.new.peg_to_fam(fid)
            nfams[nfam] = nfams.get(nfam, 0) + 1
            n += 1
        if n == 0:
            return
        by_weight = sort_by_values(nfams)
        cand = by_weight[0][0]
        frac = by_weight[0][1] / n
        if frac > 0.75 and not self.new_fam_name.get(cand, ""):
            self.new_fam_name[cand] = fam
            self.old_fam_used[fam] = cand
            self.log_result(f"{cand} NOW {fam} weight={'%g' % frac}\n")

    # -- output --------------------------------------------------------------

    def write_unmapped(self) -> None:
        self.log_result("Unmapped new:\n")
        for new_fam in sorted(self.new.fam_to_md5s):
            name = self.new_fam_name.get(new_fam, "")
            fn = self.new.fam_to_function.get(new_fam, "")
            if not name:
                self.log_result(f"\t{new_fam}\t{fn}\n")
            else:
                self.log_result(f"M\t{new_fam}\t{fn}\t{name}\n")

    def run(self) -> list[str]:
        self.phase_1()
        self.phase_2()
        self.phase_3()
        self.write_unmapped()
        return self.results
