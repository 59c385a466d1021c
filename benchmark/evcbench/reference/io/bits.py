"""MSB-first bit writer/reader with exp-Golomb, matching the EVC HLS layer
(reference: src_base/xeve_bsw.c for writing semantics)."""
from __future__ import annotations


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.cur = 0
        self.nbits = 0

    def write(self, val: int, length: int):
        assert 0 < length <= 32 and 0 <= val < (1 << length), (val, length)
        self.cur = (self.cur << length) | val
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.cur >> self.nbits) & 0xFF)
        self.cur &= (1 << self.nbits) - 1

    def write1(self, val: int):
        self.write(val & 1, 1)

    def write_ue(self, val: int):
        nn = (val + 1) >> 1
        len_i = 0
        while len_i < 16 and nn != 0:
            nn >>= 1
            len_i += 1
        info = val + 1 - (1 << len_i)
        code = (1 << len_i) | (info & ((1 << len_i) - 1))
        self.write(code, (len_i << 1) + 1)

    def write_se(self, val: int):
        self.write_ue(-val * 2 if val <= 0 else val * 2 - 1)

    def is_byte_aligned(self) -> bool:
        return self.nbits == 0

    def byte_align(self):
        while self.nbits:
            self.write1(0)

    def get_bytes(self) -> bytes:
        assert self.nbits == 0, "unaligned"
        return bytes(self.buf)


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte_pos = pos
        self.bit_pos = 0

    def read1(self) -> int:
        b = self.data[self.byte_pos]
        bit = (b >> (7 - self.bit_pos)) & 1
        self.bit_pos += 1
        if self.bit_pos == 8:
            self.bit_pos = 0
            self.byte_pos += 1
        return bit

    def read(self, length: int) -> int:
        v = 0
        for _ in range(length):
            v = (v << 1) | self.read1()
        return v

    def read_ue(self) -> int:
        len_i = 0
        while self.read1() == 0:
            len_i += 1
            assert len_i <= 32
        info = self.read(len_i) if len_i else 0
        return (1 << len_i) + info - 1

    def read_se(self) -> int:
        v = self.read_ue()
        return (v + 1) >> 1 if v & 1 else -(v >> 1)

    def byte_align(self):
        while self.bit_pos:
            self.read1()

    def is_byte_aligned(self) -> bool:
        return self.bit_pos == 0
