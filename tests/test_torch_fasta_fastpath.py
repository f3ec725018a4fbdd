"""The port's FastaParser, whose ``parse_chunk`` reads clean records whole
with one anchored regex, against the JAX package's char-at-a-time state
machine (``close_kmers_tpu/io/fasta.py``), and the server's record
counters (``server/http.py`` ``_fasta_batches``).

The differential fuzz feeds both parsers seeded random bodies that mix
clean records with every quirk of the reference's parser, whole and cut
into chunks at random places (inside ``\\r\\n`` and right after ``\\n``
among them), as ``str`` and as latin-1 ``bytes``, and compares every
callback (``on_seq``, ``on_def_seq``, ``on_error`` with its message, line
number and id) and where each chunk's calls end, also with an
``on_error`` that stops the parse partway.
"""

import asyncio
import random
import types

import pytest

from close_kmers_tpu.io import fasta as JFA
from close_kmers_tpu_torch.io import fasta as TFA
from close_kmers_tpu_torch.server import http
from close_kmers_tpu_torch.utils import metrics as M

UPPER = "ACDEFGHIKLMNPQRSTVWY"
LETTERS = UPPER + "acdefghiklmnpqrstvwyBJOUXZbjouxz"
BLOCKS = 10
BODIES_PER_BLOCK = 25


def _residues(rng, n, star=0.0):
    return "".join("*" if rng.random() < star else rng.choice(LETTERS)
                   for _ in range(n))


def _clean(rng, cols=60):
    """A record the regex reads whole: id, an optional defline after a
    space or a tab, data lines of ``cols`` residues ('*' inside them, and
    anywhere in the first)."""
    rid = "".join(rng.choice("abcXYZ019|._-") for _ in range(rng.randint(0,
                                                                         12)))
    head = ">" + rid
    if rng.random() < 0.7:
        head += rng.choice(" \t") + rng.choice(
            ["hypothetical protein", "x\ty  z", "", " lead", "[E. coli]"])
    seq = _residues(rng, rng.randint(0, 200), star=0.02)
    lines = [seq[a:a + cols] for a in range(0, len(seq), cols)] or [""]
    lines = [lines[0]] + [ln if ln[:1] != "*" else "M" + ln[1:]
                          for ln in lines[1:]]
    return [head] + lines


def _quirk(rng, wide):
    """Lines the state machine reads with an error, or by a path the
    regex leaves to it."""
    good = _residues(rng, rng.randint(1, 30))
    kind = rng.randrange(14)
    if kind == 0:      # '*' opening a later data line: rejected there
        return [">s0", good, "*" + good, "**", good]
    if kind == 1:      # '*' opening the first data line: accepted
        return [">s1 d", "*" + good, good]
    if kind == 2:      # digits, '-' and spaces in data
        return [">s2", good[:5] + "12-3 " + good[5:], good]
    if kind == 3:      # latin-1 letters: isalpha(), not ASCII
        return rng.choice([[">s3 caf\xe9", good + "\xe9\xdf" + good],
                           [">s3", good, "\xdc" + good, good]])
    if kind == 4:      # '>' in the middle of a data line
        return [">s4", good + ">x y" + good, good]
    if kind == 5:      # a header followed at once by another
        return [">s5 a", ">s5b b", good]
    if kind == 6:      # empty records, blank lines
        return [">s6", "", ">", "", "", ">s6c", good, "", good]
    if kind == 7:      # blanks and tabs in headers
        return ["> s7 lead", good, ">\ts7\ttab", good, ">s7  two", good]
    if kind == 8:      # junk between records, at a line start
        return [good, "1 2", ">s8", good]
    if kind == 9:      # a '\r' inside a line (stripped everywhere)
        return [">s9\rx", good[:3] + "\r" + good[3:], "\r", good]
    if kind == 10:     # junk then '>' on one later data line
        return [">s10", good, "12>s10b desc", good]
    if kind == 11:     # only a header
        return [">s11 end"]
    if kind == 12:     # not a latin-1 character (str bodies only)
        return [">s12", good + ("\u212a" if wide else "k") + good]
    return [">s13", good, "-" + good, " " + good]


def _body(seed: int) -> tuple[str, bool]:
    """A random body and whether it is text only (no latin-1 bytes)."""
    rng = random.Random(seed)
    wide = seed % 3 == 0
    if seed % 50 == 7:
        return "", wide
    lines = []
    if rng.random() < 0.15:                 # a body not starting with '>'
        lines += rng.choice([["junk line"], ["", "ACDE"], ["*"], [""]])
    for _ in range(rng.randint(0, 25)):
        lines += _quirk(rng, wide) if rng.random() < 0.3 else _clean(rng)
        if rng.random() < 0.1:
            lines.append("")
    crlf = rng.random()
    text = "".join(ln + ("\r\n" if rng.random() < crlf * 0.5 else "\n")
                   for ln in lines)
    if text and rng.random() < 0.3:         # no final newline
        text = text.rstrip("\n").rstrip("\r")
    return text, wide


def _cuts(rng, text: str) -> list[int]:
    """Random cut points, with some inside '\\r\\n' and right after '\\n'."""
    n = len(text)
    cuts = {rng.randint(0, n) for _ in range(rng.randint(0, 6))}
    crlf = [i + 1 for i in range(n - 1) if text[i:i + 2] == "\r\n"]
    nl = [i + 1 for i in range(n) if text[i] == "\n"]
    for pool in (crlf, nl):
        if pool:
            cuts.update(rng.sample(pool, min(len(pool), rng.randint(0, 3))))
    return sorted(cuts)


def _events(module, chunks, stop_after=None):
    """Every callback of ``module.FastaParser`` fed ``chunks``, a marker
    after each chunk, and the final line number; ``on_error`` returns
    False at its ``stop_after``-th call."""
    ev, errs = [], []

    def on_error(msg, line, rid):
        ev.append(("error", msg, line, rid))
        errs.append(msg)
        return stop_after is None or len(errs) < stop_after

    p = module.FastaParser(
        on_seq=lambda i, s: ev.append(("seq", i, s)),
        on_def_seq=lambda i, d, s: ev.append(("def_seq", i, d, s)),
        on_error=on_error)
    for c in chunks:
        p.parse_chunk(c)
        ev.append(("chunk", p.line_number))
    p.parse_complete()
    ev.append(("complete", p.line_number))
    return ev, p


def _split(data, cuts):
    edges = [0] + list(cuts) + [len(data)]
    return [data[a:b] for a, b in zip(edges, edges[1:])]


@pytest.mark.parametrize("block", range(BLOCKS))
def test_fuzz_matches_the_state_machine(block):
    """The same calls, in the same order, per chunk, on every body, every
    chunking, ``str`` or ``bytes``, with and without a stop; both paths
    taken across the block."""
    fast = slow = 0
    for k in range(BODIES_PER_BLOCK):
        seed = 1_000_003 * block + k
        text, wide = _body(seed)
        rng = random.Random(seed ^ 0x5EED)
        forms = [text] if wide else [text, text.encode("latin-1")]
        for data in forms:
            for cuts in ([], _cuts(rng, text), _cuts(rng, text)):
                chunks = _split(data, cuts)
                want, _ = _events(JFA, chunks)
                got, p = _events(TFA, chunks)
                assert got == want, (seed, cuts)
                fast += p.records_fast
                slow += p.records - p.records_fast
                n_err = sum(e[0] == "error" for e in want)
                if n_err:
                    stop = rng.randint(1, n_err)
                    assert _events(TFA, chunks, stop)[0] == \
                        _events(JFA, chunks, stop)[0], (seed, cuts, stop)
    assert fast > 100 and slow > 100


@pytest.mark.parametrize("body, fast, records", [
    (">a x\nMK*V\nLL\n\nAC\n>b\n*M\n>c\nAA\n", 2, 3),
    (">a\nMK\n*AC\n>b\nAA\n>c\nCC\n", 1, 3),      # '*' opens line 3
    (">a\n>b\nAA\n>c\nCC\n>d\n", 1, 3),           # header after header
    (">a\nM\xe9K\n>b\nAA\n>c\n", 1, 3),            # latin-1 letter
    (">a\nAA\n\xe9A\n>b\nAA\n>c\n", 1, 3),       # opening a later line
    ("x\n>a\nAA\n>b\nCC\n>c", 1, 3),   # junk first; '>c' unfinished
    (">a\nAA\n>b\nCC", 1, 2),                     # last record unfinished
    ("", 0, 0),
])
def test_which_records_take_the_fast_path(body, fast, records):
    want, _ = _events(JFA, [body])
    got, p = _events(TFA, [body])
    assert got == want
    assert (p.records_fast, p.records) == (fast, records)


def test_public_functions_match_the_state_machine():
    text, _ = _body(11)
    assert TFA.parse_fasta_bytes(text) == JFA.parse_fasta_bytes(text)
    assert TFA.parse_fasta_bytes(text.encode("latin-1")) == \
        JFA.parse_fasta_bytes(text.encode("latin-1"))


# -- the server's counters ----------------------------------------------------

def _genome(rng, n, bad=False):
    """``n`` proteins of lognormal lengths (median 270 aa) in 60-residue
    lines; with ``bad`` every record carries a digit."""
    out = []
    for i in range(n):
        seq = "".join(rng.choice(UPPER) for _ in range(
            max(50, min(1500, int(rng.lognormvariate(5.6, 0.6))))))
        if bad:
            seq = seq[:20] + "7" + seq[20:]
        out.append(f">fig|83333.1.peg.{i} protein {i}\n")
        out += [seq[a:a + 60] + "\n" for a in range(0, len(seq), 60)]
    return "".join(out).encode()


class _Body:
    def __init__(self, data: bytes, n_chunks: int):
        step = -(-len(data) // n_chunks)
        self.parts = [data[a:a + step] for a in range(0, len(data), step)]

    async def chunks(self):
        for c in self.parts:
            yield c


def _batches(data: bytes, n_chunks: int, tracing: bool):
    m = M.Metrics()
    m.tracing = tracing
    ctx = types.SimpleNamespace(metrics=m, batch_size=2048)

    async def run():
        with m.span("request", 1, cpu=False) as req:
            out = [b async for b in http._fasta_batches(
                ctx, _Body(data, n_chunks))]
        return out, req

    out, req = asyncio.run(run())
    return out, m, req


def _expected_batches(data: bytes) -> list:
    items = [(i, s) for i, _d, s in JFA.parse_fasta_bytes(data)]
    return [items[a:a + 2048] for a in range(0, len(items), 2048)]


@pytest.mark.parametrize("bad", [False, True])
def test_fasta_batches_count_fast_records(bad):
    """A clean two-chunk genome body: >= 99% of its records read whole;
    one whose every record has a bad character: none.  The batches are
    the state machine's either way: ids, sequences, the 2,048 split."""
    data = _genome(random.Random(19), 2500, bad)
    out, m, req = _batches(data, 2, True)
    assert out == _expected_batches(data)
    assert [len(b) for b in out] == [2048, 452]
    n, n_fast = m.counters["parse_records"], m.counters["parse_records_fast"]
    assert n == 2500
    assert req.attrs["parse_records"] == n
    assert req.attrs["parse_records_fast"] == n_fast
    if bad:
        assert n_fast == 0
    else:
        assert n_fast / n >= 0.99
    off, m_off, _ = _batches(data, 2, False)
    assert off == out and m_off.counters == {}
