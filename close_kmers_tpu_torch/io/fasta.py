# Ports close_kmers_tpu/io/fasta.py, with a record fast path in FastaParser;
# held to it by tests/test_torch_host.py and tests/test_torch_fasta_fastpath.py.
"""Streaming FASTA/FASTQ parsers with reference-parity semantics.

Replicates the char-at-a-time state machines of the reference
(fasta_parser.h:38-144, fastq_parser.h:40-151) using
line-oriented processing for speed, preserving the observable quirks:

FASTA:
* '\\r' is ignored everywhere (fasta_parser.h:47-48);
* the defline includes the blank separator character (fasta_parser.h:64-68);
* sequence data accepts letters and '*'; other characters are reported
  and skipped (fasta_parser.h:91-107);
* at a line start inside a record (state s_id_or_data) '*' is NOT
  accepted — leading '*'s are skipped until a letter or '>'
  (fasta_parser.h:109-133);
* parse_complete emits the final record unconditionally, even if empty
  (fasta_parser.cc:30-36).

``FastaParser.parse_chunk`` reads a whole record at C speed where the
state machine would read it without an error: one regex, anchored at a
'>' line start, takes the header, a first data line of letters and '*',
further lines that are empty or start with a letter, and needs the next
'>' line inside the chunk's complete lines.  Any other line goes through
the state machine (``_feed_line``), so every callback, its message, line
number and id come out as the state machine alone gives them.

FASTQ (fastq_parser.h):
* 4-line records @id / seq / + / qual; quality parsed but discarded;
* leading '>' is diagnosed as FASTA-vs-FASTQ confusion;
* no '\\r' stripping (unlike the FASTA parser) — '\\r' lands in ids;
* sequence accepts letters only.
"""

from __future__ import annotations

import re
from typing import Callable, Iterator

OnSeq = Callable[[str, str], None]
OnDefSeq = Callable[[str, str, str], None]
OnError = Callable[[str, int, str], bool]


def _is_alpha(c: str) -> bool:
    return c.isascii() and c.isalpha()


# A clean record: header (id up to the first blank, the rest the
# defline), a first data line in which '*' may stand anywhere, lines that
# are empty or open with an ASCII letter (a '*' there is an error,
# fasta_parser.h:109-133), ended by the next record's '>'.  Possessive
# quantifiers: a record that fails is rejected without backtracking.
_CLEAN_RECORD = re.compile(
    r">([^ \t\n]*+)([^\n]*+)\n"
    r"([A-Za-z*]*+\n(?:(?:[A-Za-z][A-Za-z*]*+)?\n)*+)(?=>)")


class FastaParser:
    S_START, S_ID, S_DATA_FIRST, S_DATA = range(4)

    def __init__(self, on_seq: OnSeq | None = None,
                 on_def_seq: OnDefSeq | None = None,
                 on_error: OnError | None = None):
        self.on_seq = on_seq
        self.on_def_seq = on_def_seq
        self.on_error = on_error
        self.state = self.S_START
        self.cur_id: str = ""
        self.cur_def: str = ""
        self.cur_seq: list[str] = []
        self.line_number = 1
        self._tail = ""
        self._stop = False
        # records begun, and those of them read whole by _CLEAN_RECORD
        self.records = 0
        self.records_fast = 0

    # -- internal ------------------------------------------------------------

    def _emit(self) -> None:
        seq = "".join(self.cur_seq)
        if self.on_seq:
            self.on_seq(self.cur_id, seq)
        if self.on_def_seq:
            self.on_def_seq(self.cur_id, self.cur_def, seq)
        self.cur_id, self.cur_def, self.cur_seq = "", "", []

    def _error(self, msg: str) -> None:
        if self.on_error is not None:
            if not self.on_error(msg, self.line_number, self.cur_id):
                self._stop = True

    def _start_record(self, after_gt: str) -> None:
        self.records += 1
        # id up to first blank; blank + rest becomes the defline
        for i, c in enumerate(after_gt):
            if c in " \t":
                self.cur_id = after_gt[:i]
                self.cur_def = after_gt[i:]
                break
        else:
            self.cur_id = after_gt
            self.cur_def = ""
        self.state = self.S_DATA_FIRST

    def _data_chars(self, line: str) -> str:
        kept = []
        for c in line:
            if _is_alpha(c) or c == "*":
                kept.append(c)
            else:
                self._error(f"Bad data character '{c}'")
        return "".join(kept)

    def _feed_line(self, line: str) -> None:
        if self._stop:
            return
        if self.state == self.S_START:
            if not line:
                return
            if line[0] != ">":
                self._error("Missing >")
                return
            self._start_record(line[1:])
            return
        if self.state == self.S_DATA_FIRST:
            # first data line of a record: '*' accepted at any position
            self.cur_seq.append(self._data_chars(line))
            self.state = self.S_DATA
            return
        # S_DATA: line starts in the reference's s_id_or_data state
        i = 0
        while i < len(line):
            c = line[i]
            if c == ">":
                self._emit()
                self._start_record(line[i + 1:])
                return
            if _is_alpha(c):
                break
            # '*' or junk at line start is rejected char-by-char
            # (fasta_parser.h:109-133)
            self._error(f"Bad id or data character '{c}'")
            i += 1
        if i < len(line):
            self.cur_seq.append(self._data_chars(line[i:]))

    # -- public --------------------------------------------------------------

    def parse_chunk(self, data: str | bytes) -> None:
        if isinstance(data, bytes):
            data = data.decode("latin-1")
        text = self._tail + data.replace("\r", "")
        end = text.rfind("\n") + 1       # text[end:] is an unfinished line
        self._tail = text[end:]
        match = _CLEAN_RECORD.match
        pos = 0
        while pos < end:
            if self._stop:
                self.line_number += text.count("\n", pos, end)
                return
            if text[pos] == ">" and self.state in (self.S_START,
                                                   self.S_DATA):
                m = match(text, pos, end)
                if m:
                    if self.state == self.S_DATA:
                        self._emit()
                    self.cur_id, self.cur_def, lines = m.groups()
                    self.cur_seq = [lines.replace("\n", "")]
                    self.state = self.S_DATA
                    self.records += 1
                    self.records_fast += 1
                    self.line_number += lines.count("\n") + 1
                    pos = m.end()
                    continue
            nl = text.index("\n", pos)
            self._feed_line(text[pos:nl])
            self.line_number += 1
            pos = nl + 1

    def parse_complete(self) -> None:
        if self._tail:
            self._feed_line(self._tail)
            self._tail = ""
        self._emit()
        self.state = self.S_START


class FastqParser:
    S_ID, S_DATA, S_PLUS, S_QUAL = range(4)

    def __init__(self, on_seq: OnSeq | None = None,
                 on_def_seq: OnDefSeq | None = None,
                 on_error: OnError | None = None):
        self.on_seq = on_seq
        self.on_def_seq = on_def_seq
        self.on_error = on_error
        self.state = self.S_ID
        self.cur_id = ""
        self.cur_def = ""
        self.cur_seq = ""
        self.line_number = 1
        self._tail = ""
        self._stop = False

    def _emit(self) -> None:
        if self.on_seq:
            self.on_seq(self.cur_id, self.cur_seq)
        if self.on_def_seq:
            self.on_def_seq(self.cur_id, self.cur_def, self.cur_seq)
        self.cur_id, self.cur_def, self.cur_seq = "", "", ""

    def _error(self, msg: str) -> None:
        if self.on_error is not None:
            if not self.on_error(msg, self.line_number, self.cur_id):
                self._stop = True

    def _feed_line(self, line: str) -> None:
        if self._stop:
            return
        if self.state == self.S_ID:
            i = 0
            # skip garbage until '@' (fastq_parser.h:52-65)
            while i < len(line) and line[i] != "@":
                if line[i] == ">":
                    self._error("Starts with >. Is this a fasta file not a fastq file?")
                else:
                    self._error("Missing @")
                i += 1
            if i >= len(line):
                return
            rest = line[i + 1:]
            for j, c in enumerate(rest):
                if c in " \t":
                    self.cur_id = rest[:j]
                    self.cur_def = rest[j:]
                    break
            else:
                self.cur_id = rest
                self.cur_def = ""
            self.state = self.S_DATA
            return
        if self.state == self.S_DATA:
            kept = []
            for c in line:
                if _is_alpha(c):
                    kept.append(c)
                else:
                    self._error(f"Bad data character '{c}'")
            self.cur_seq = "".join(kept)
            self.state = self.S_PLUS
            return
        if self.state == self.S_PLUS:
            if not line.startswith("+"):
                self._error("Missing +")
            self.state = self.S_QUAL
            return
        # S_QUAL: discard quality (fastq_parser.h:130-139)
        self._emit()
        self.state = self.S_ID

    def parse_chunk(self, data: str | bytes) -> None:
        if isinstance(data, bytes):
            data = data.decode("latin-1")
        data = self._tail + data
        lines = data.split("\n")
        self._tail = lines.pop()
        for line in lines:
            self._feed_line(line)
            self.line_number += 1

    def parse_complete(self) -> None:
        if self._tail:
            self._feed_line(self._tail)
            self._tail = ""
        self._emit()
        self.state = self.S_ID


def parse_fasta_file(path: str) -> Iterator[tuple[str, str, str]]:
    """Yield (id, defline, seq) triples from a FASTA file; the final
    unconditional empty record from parse_complete is suppressed unless
    it carries data."""
    out: list[tuple[str, str, str]] = []
    p = FastaParser(on_def_seq=lambda i, d, s: out.append((i, d, s)))
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            p.parse_chunk(chunk)
    p.parse_complete()
    for rec in out:
        if rec[0] or rec[2]:
            yield rec


def parse_fasta_bytes(data: bytes | str) -> list[tuple[str, str, str]]:
    out: list[tuple[str, str, str]] = []
    p = FastaParser(on_def_seq=lambda i, d, s: out.append((i, d, s)))
    p.parse_chunk(data)
    p.parse_complete()
    return [r for r in out if r[0] or r[2]]


def parse_fastq_bytes(data: bytes | str) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    p = FastqParser(on_seq=lambda i, s: out.append((i, s)))
    p.parse_chunk(data)
    p.parse_complete()
    return [r for r in out if r[0] or r[1]]
