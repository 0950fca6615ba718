"""Classical linear-block-code utilities.

Same public surface as the reference's self-contained teaching module
(src/par2gen.py, not imported by the simulators): systematic H<->G
conversion, codeword/syndrome maps, exhaustive minimum distance, weight
distribution, standard-array and syndrome-table decoding.  Internals are
vectorized numpy (all 2^k codewords at once) rather than per-integer loops.

Systematic conventions (reference src/par2gen.py:4-59):
  G = [P | I_k]  (k x n),   H = [I_{n-k} | P^T]  ((n-k) x n).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "HtoG", "GtoH", "GtoP", "HtoP", "w", "d", "intToArray", "arrayToString",
    "nCr", "matrixMultiplicationEquations", "LinearBlockCode",
]


def HtoP(H):
    """P from a systematic parity-check matrix (src/par2gen.py:48-59)."""
    H = np.asarray(H)
    n = H.shape[1]
    k = n - H.shape[0]
    return np.transpose(H[:, n - k:]).astype(int)


def GtoP(G):
    """P from a systematic generator matrix (src/par2gen.py:35-45)."""
    G = np.asarray(G)
    k, n = G.shape
    return G[:, : n - k].astype(int)


def HtoG(H):
    """Systematic H -> G (src/par2gen.py:4-16)."""
    H = np.asarray(H)
    k = H.shape[1] - H.shape[0]
    return np.concatenate([HtoP(H), np.eye(k, dtype=int)], axis=1)


def GtoH(G):
    """Systematic G -> H (src/par2gen.py:19-32)."""
    G = np.asarray(G)
    k, n = G.shape
    return np.concatenate([np.eye(n - k, dtype=int), GtoP(G).T], axis=1)


def w(v) -> int:
    """Hamming weight (src/par2gen.py:93-100)."""
    return int(np.count_nonzero(v))


def d(v1, v2) -> int:
    """Hamming distance (src/par2gen.py:103-111)."""
    return w((np.asarray(v1) + np.asarray(v2)) % 2)


def intToArray(i: int, length: int = 0) -> np.ndarray:
    """Little-endian bit array of integer i (src/par2gen.py:114-128)."""
    bits = [(i >> b) & 1 for b in range(max(length, i.bit_length()))]
    return np.array(bits, dtype=int)


def arrayToString(a) -> str:
    """'0101...' rendering of a bit vector (src/par2gen.py:131-141)."""
    return "".join(str(int(x)) for x in np.asarray(a).ravel())


def nCr(n: int, k: int) -> float:
    """Binomial coefficient (src/par2gen.py:144-149)."""
    return math.comb(n, k)


def matrixMultiplicationEquations(M, aSymbol: str, bSymbol: str) -> str:
    """Human-readable GF(2) product equations a = b.M
    (src/par2gen.py:62-90)."""
    M = np.asarray(M)
    rows, cols = M.shape
    lines = []
    for j in range(cols):
        terms = [f"{bSymbol}{i}" for i in range(rows) if M[i, j]]
        lines.append(f"{aSymbol}{j} = " + (" + ".join(terms) if terms else "0"))
    return "\n".join(lines)


def _all_messages(k: int) -> np.ndarray:
    """(2^k, k) matrix of all messages, little-endian bit order."""
    ints = np.arange(2**k, dtype=np.int64)
    return ((ints[:, None] >> np.arange(k)) & 1).astype(int)


class LinearBlockCode:
    """Systematic [n, k] linear block code (reference class
    src/par2gen.py:153-509)."""

    def __init__(self, G=None, H=None):
        self.__G = None
        self.__table = None
        if G is not None:
            self.setG(G)
        elif H is not None:
            self.setH(H)

    # ------------------------------------------------------------ matrices
    def G(self):
        return self.__G

    def setG(self, G):
        self.__G = np.asarray(G).astype(int)
        self.__table = None

    def H(self):
        return GtoH(self.__G)

    def setH(self, H):
        self.__G = HtoG(H).astype(int)
        self.__table = None

    def P(self):
        return GtoP(self.__G)

    def k(self) -> int:
        return self.__G.shape[0]

    def n(self) -> int:
        return self.__G.shape[1]

    def R(self) -> float:
        return self.k() / self.n()

    # ------------------------------------------------------------ codewords
    def c(self, m):
        """Encode message m (src/par2gen.py:210-218)."""
        return (np.asarray(m).dot(self.G()) % 2).astype(int)

    def s(self, r):
        """Syndrome of a received/error vector (src/par2gen.py:220-229)."""
        return (np.asarray(r).dot(self.H().T) % 2).astype(int)

    def M(self):
        """All 2^k messages (src/par2gen.py:231-238)."""
        return _all_messages(self.k())

    def C(self):
        """All 2^k codewords (src/par2gen.py:240-250)."""
        return (self.M() @ self.G() % 2).astype(int)

    # ------------------------------------------------------------ distance
    def dmin(self, Verbose: bool = False) -> int:
        """Exhaustive minimum distance (src/par2gen.py:252-270)."""
        weights = self.C().sum(axis=1)
        dmin = int(weights[weights > 0].min()) if (weights > 0).any() else self.n()
        if Verbose:
            print("dmin =", dmin)
        return dmin

    def dminVerbose(self) -> int:
        return self.dmin(Verbose=True)

    def errorDetectionCapability(self) -> int:
        return self.dmin() - 1

    def t(self) -> int:
        """Error-correction capability floor((dmin-1)/2)."""
        return math.floor((self.dmin() - 1) / 2)

    # --------------------------------------------------------- probabilities
    def Ai(self, i: int) -> int:
        """Number of codewords of weight i (src/par2gen.py:309-319)."""
        return int((self.C().sum(axis=1) == i).sum())

    def A(self):
        """Weight distribution A_0..A_n (src/par2gen.py:321-330)."""
        weights = self.C().sum(axis=1)
        return np.bincount(weights, minlength=self.n() + 1).astype(int)

    def PU(self, p: float) -> float:
        """Probability of undetected error (src/par2gen.py:286-295)."""
        n = self.n()
        A = self.A()
        return float(sum(A[i] * p**i * (1 - p) ** (n - i) for i in range(1, n + 1)))

    def Pe(self, p: float) -> float:
        """Block error probability after t-error correction
        (src/par2gen.py:297-307)."""
        n, t = self.n(), self.t()
        return float(1 - sum(
            nCr(n, i) * p**i * (1 - p) ** (n - i) for i in range(0, t + 1)
        ))

    # ------------------------------------------------------------- decoding
    def correctableErrorPatterns(self):
        """All weight-<=t error patterns (src/par2gen.py:414-428)."""
        n, t = self.n(), self.t()
        rows = [e for i in range(2**n)
                if w(e := intToArray(i, n)) <= t]
        limit = 2 ** self.H().shape[0]
        return np.array(rows[:limit], dtype=int)

    def decodingTable(self) -> dict:
        """syndrome-string -> error-pattern table, cached per G
        (src/par2gen.py:424-438 rebuilds the 2^n enumeration per call)."""
        if self.__table is None:
            self.__table = {
                arrayToString(self.s(e)): e
                for e in self.correctableErrorPatterns()
            }
        return self.__table

    def syndromeDecode(self, r):
        """Syndrome-table decoding (src/par2gen.py:439-450)."""
        e = self.decodingTable()[arrayToString(self.s(r))]
        return ((np.asarray(r) + e) % 2).astype(int)

    def verboseSyndromeDecode(self, r):
        print("Decoding received vector r =", r)
        s = self.s(r)
        print("s = r * H' =", s)
        self.printDecodingTable()
        e = self.decodingTable()[arrayToString(s)]
        print("-> find error pattern e =", e)
        c = ((np.asarray(r) + e) % 2).astype(int)
        print("c = r + e =", c)
        return c

    # ------------------------------------------------------------- printing
    def printMessageCodewordTable(self):
        print("Messages -> Codewords")
        for m, c in zip(self.M(), self.C()):
            print(m, "->", c)

    def printParityCheckEquations(self):
        print(matrixMultiplicationEquations(self.G(), "c", "m"))

    def printSyndromeVectorEquations(self):
        print(matrixMultiplicationEquations(self.H().T, "s", "r"))

    def printErrorsThatHaveSyndrome(self, s):
        target = np.asarray(s)
        print("e0 e1 e2 ... -> weight")
        for i in range(2 ** self.n()):
            e = intToArray(i, self.n())
            if np.array_equal(self.s(e), target):
                print(e, "->", w(e))

    def printStandardArray(self):
        """Standard array of coset leaders (src/par2gen.py:386-412)."""
        t = self.t()
        C = self.C()
        first = True
        for j in range(2 ** self.n()):
            e = intToArray(j, self.n())
            if w(e) <= t:
                cells = [arrayToString((c + e) % 2) for c in C]
                print(cells[0] + " | " + " ".join(cells[1:]))
                if first:
                    first = False
                    print("-" * ((2 ** self.k()) * (self.n() + 1) + 1))

    def printDecodingTable(self):
        print("Correctable Error Patterns -> Syndromes")
        for e in self.correctableErrorPatterns():
            print(e, self.s(e))

    def printInfo(self):
        print(f"[n={self.n()}, k={self.k()}] linear block code, "
              f"R={self.R():.3f}, dmin={self.dmin()}")
