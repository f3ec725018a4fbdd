"""/query with the default output grammar (query_request.cc:68-152): a
PROTEIN-ID line, the CALL lines and an OTU-COUNTS line a protein, in
request order.  The server runs in plain (non-family) mode."""

from ..reference import answers

PATH = b"/query"
FAMILY_MODE = False
# a protein's record ends with this line
RECORD_END = b"OTU-COUNTS\t"


def split_records(body: bytes) -> list:
    """The answer body's records, one a protein, in order."""
    if not body:
        return []
    parts = body.split(b"\nPROTEIN-ID\t")
    recs = [parts[0] + b"\n"] + [b"PROTEIN-ID\t" + p + b"\n"
                                 for p in parts[1:]]
    recs[-1] = recs[-1][:-1]
    return recs


def record_id(rec: bytes) -> str:
    if not rec.startswith(b"PROTEIN-ID\t"):
        return ""
    return rec[11:rec.find(b"\t", 11)].decode("latin-1")


def expected(ref, sid: str, seq: bytes, params) -> str:
    return answers.query_record(ref, sid, seq, params)
