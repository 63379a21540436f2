"""Alphabets with complement tables.

Replicates the alphabet surface of the reference CLI (tsalign/src/align.rs:261-295,
README.md:89-96): dna, dna-n, rna, rna-n, dna-iupac, rna-iupac.

Characters are encoded as small integers (the index of the character in the
alphabet's canonical order); sequences become int8 numpy arrays so they can be
shipped to the TPU directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_IUPAC_COMPLEMENT = {
    "A": "T",
    "B": "V",
    "C": "G",
    "D": "H",
    "G": "C",
    "H": "D",
    "K": "M",
    "M": "K",
    "N": "N",
    "R": "Y",
    "S": "S",
    "T": "A",
    "V": "B",
    "W": "W",
    "Y": "R",
    "U": "A",
}


@dataclass(frozen=True)
class Alphabet:
    name: str
    letters: str
    # complement[i] = index of the complement of letters[i]
    complement: tuple = field(default=())

    @property
    def size(self) -> int:
        return len(self.letters)

    def index(self, char: str) -> int:
        i = self.letters.find(char)
        if i < 0:
            raise ValueError(
                f"Character {char!r} is not part of alphabet {self.name!r} ({self.letters})"
            )
        return i

    def encode(self, sequence: str) -> np.ndarray:
        """Encode an (uppercase) string into an int8 index array."""
        lut = np.full(256, -1, dtype=np.int8)
        for i, c in enumerate(self.letters):
            lut[ord(c)] = i
        arr = lut[np.frombuffer(sequence.encode("ascii"), dtype=np.uint8)]
        if (arr < 0).any():
            bad = sorted({sequence[i] for i in np.nonzero(arr < 0)[0][:5]})
            raise ValueError(
                f"Sequence contains non-alphabet character(s) {bad} for alphabet "
                f"{self.name!r} ({self.letters})"
            )
        return arr

    def decode(self, arr) -> str:
        return "".join(self.letters[int(i)] for i in arr)

    def complement_index(self, index: int) -> int:
        return self.complement[index]

    def complement_str(self, sequence: str) -> str:
        return "".join(
            self.letters[self.complement[self.index(c)]] for c in sequence
        )

    def reverse_complement_str(self, sequence: str) -> str:
        return self.complement_str(sequence)[::-1]

    def complement_array(self) -> np.ndarray:
        return np.asarray(self.complement, dtype=np.int8)


def _make(name: str, letters: str) -> Alphabet:
    def comp_char(c: str) -> str:
        cc = _IUPAC_COMPLEMENT[c]
        if cc == "T" and "T" not in letters:
            cc = "U"  # RNA alphabets pair A with U
        return cc

    comp = tuple(letters.index(comp_char(c)) for c in letters)
    return Alphabet(name=name, letters=letters, complement=comp)


# Canonical orders follow the reference README (README.md:89-96).
ALPHABETS = {
    "dna": _make("dna", "ACGT"),
    "dna-n": _make("dna-n", "ACGTN"),
    "rna": _make("rna", "ACGU"),
    "rna-n": _make("rna-n", "ACGUN"),
    "dna-iupac": _make("dna-iupac", "ABCDGHKMNRSTVWY"),
    "rna-iupac": _make("rna-iupac", "ABCDGHKMNRSUVWY"),
}


def get_alphabet(name: str) -> Alphabet:
    try:
        return ALPHABETS[name]
    except KeyError:
        raise ValueError(
            f"Unknown alphabet {name!r}; available: {sorted(ALPHABETS)}"
        ) from None
