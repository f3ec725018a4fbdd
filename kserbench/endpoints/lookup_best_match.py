"""/lookup?find_best_match=1 on a family-mode server
(lookup_request.cc:203-326): one line a protein, in request order: its
id, the best global family (PGF) and its score, the best local family
(PLF) of the target genus and its score, the best call's function, its
score and its weighted score."""

from ..reference import answers

PATH = b"/lookup?find_best_match=1"
FAMILY_MODE = True
# every line is a protein's record
RECORD_END = b""


def split_records(body: bytes) -> list:
    if not body:
        return []
    return [line + b"\n" for line in body.split(b"\n")[:-1]]


def record_id(rec: bytes) -> str:
    return rec[:rec.find(b"\t")].decode("latin-1")


def expected(ref, sid: str, seq: bytes, params) -> str:
    return answers.best_match_record(ref, sid, seq, params)
