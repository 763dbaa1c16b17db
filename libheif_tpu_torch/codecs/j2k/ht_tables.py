"""HT-J2K (ISO/IEC 15444-15) CxtVLC code tables.

The two 1024-entry context-VLC decode tables of the HT cleanup pass
(T.814 Annex C): one for the initial quad-row of a code-block, one for
non-initial quad-rows.  These are normative spec constants (like DCT
matrices or CABAC tables); the values here were recovered from the
system OpenJPEG 2.5 HT decoder, which embeds the same normative tables
(reference analog: the tables consumed by
libheif/plugins/encoder_openjph.cc via OpenJPH).

Decode-table entry layout (u16), indexed by (ctx << 7) | (codeword
bits, LSB-first):

  bits 0-2   codeword length in bits (1..7)
  bit  3     u_off      (a u_q residual follows for this quad)
  bits 4-7   rho        (quad significance pattern, column-major)
  bits 8-11  e_1        (known-MSB values for flagged samples)
  bits 12-15 e_k        (per-sample known-MSB flags)

Encoder-side tables are derived at import time: for every
(ctx, rho, u_off) the codewords are listed shortest-first together
with their EMB (e_k, e_1) patterns so the encoder can pick the
cheapest codeword consistent with its exponent-attain pattern.

A copy of libheif_tpu/codecs/j2k/ht_tables.py.
"""

import base64
import struct
import zlib

_BLOB = (
    "eNqFl09MW9kVxo/tdJ+nmC4BPcMsh2JEZoeR8mh3EyHhdDUgVamzCwohYWcvHLfeNFEW"
    "nYRNkJCgVhagEM0wyQJvSOpFBEIKQyqNbAmhEEWRn/yH4GHen37nnsv0PS+mCwtdnffd"
    "37nnnnvvR4JW6AplKE/1Upxq7xK0dfEK+Sd5yvanaWYyQaOIf23laWc7TrtvEuQdIr6Y"
    "p2/pFaWGE0o/zfEK9AbibcSdPD2hNC2Q6P1GntaKcdrE2OtcIfsoT/eLr6jPSIT5U8K3"
    "TeHnzDC/bAj/lDTfDPMPSPNfCn/2nP9e+OvLwj8m4Q+ZUcxyD6wo5h/AvFHyli26hr9P"
    "iOeLIp97yC8K/QDWF0WeFl3G+D7m6zNEfxPjHcT9IvQ/WMg3ivx4vRgf3UN+UVqlAXCj"
    "VJ2y6EtwxxBfoDDfb4T5ZSPMt80wP2eG+fZRmL++HObX3oX5M5NRVEnmr3L+SXxviH5N"
    "558dhh7fvYae61Hvt6jXkPw4f9ZPT4Fvyfq8huS3yvOnMZ6/R2O8jv4Bys2Ds22R35H8"
    "uP5Bvqp/gP+gGObvVsL82S5+bS/M5/oE+WVT+FxH5qeSMaq+ddu+E8c3afBitJUsYB2D"
    "YHpPc3MxzOt2bCtO2esTqGcM836Tri26jcvkncz+Bfo96N8jfitN5Wcx7FOBavuDWIPX"
    "zGViyBv6wzhynKAlIwbuN+nditvoNeqVG6T5LeGXDeHX3gl/yBT+KQl/6bHwD0jzLc1/"
    "IfxN0vyfhL9Amn8k/Nxt4Zd/EH4K+73C/TeOulyU/vbmpP/WcB7LG1wn2Z/Xun/rFekf"
    "7j/e/5VA/6n9eyj1X1tG/z3lfsT+8Dni/duG3sL+t9F/ppyfIN9fDPO5/4L8gy7+VSvM"
    "tw/D/JwV5i+R5t8VfmqY61Mg/z9uM3vda5QXUb/lQbIzbvsa1Q+5XluPJ7Aut5Mh7+4S"
    "+uN+sQf7u4Icqo+vov5bG9A7bvOm+a3U/+kg+tBtX8bOzl7HuDRB9ke3M23VP+RuxWgs"
    "2YM6rJB/tlP8lb+g+c+Ff0zC5/1jvn0kfO4n5h+Q8FMjmn9H+EsPNX9R+DOTmv9J8+eE"
    "X34Gfmun2Id+q065zV6D+8vr7L7BfA/xvTmI+b0WnwfOj/tv2vCc9RL33yjV0L9jw16G"
    "17dTcZv+SRx75LXLL8EzJ9T5GUt6H1X9kF8tHceeZm9J/49i/dCP1D9w/YJ8rr/iHwpf"
    "zk+BVP+CL/0/Stz/im9q/gvhq/qDX9sTvqof+PYn4fP6mc/9z/yZKaeB83N2QE7n9+T6"
    "uXmnnb3ltsrPnab9kfNzGmvm7/C9gzPoOQvktKcN9yR3x2nW3tUPUyNOY2vDPdstOh3/"
    "F+hvO+2b5LY2CfqM93Nq2Gk8IehfIu56n29A/wW5Jw+K0P9UfTtkCn93W/PnNH8R+k/1"
    "D38i4f8L+fmnnvNnzX+E+Wv79cOvSPj/5rgHfUb46yWneUzgJzX/mYM7wPuM9Sr+31m/"
    "WH3bZ1yiv+J9rOI9/EcxgTvjknpP14p5VCmBOl/C+3IFd20e92wCe3KJ/olxFmPvYgLn"
    "X/Q7RdH3GqKfJtEfa/2W1vuG6Mf4vR9P4D79bb5t/TZ/8//wd7fD/FMK82cpgtsjgt6I"
    "oMMjWG8Et0QEPRKhCfwWdPy1jj8oSvwUv1H8hkyJe+MS39T6stbf0PpVrb9qSfxY61NG"
    "mL/bxZ/t4i/puH2uT4b56zruW6Kf6eLndLym9X2GjJlf0HnH9fpe6/Wr+ToyX07Ha3rO"
    "1LDEvzRFv6njNvhry7J+pZ8U/aPAOi+z3uzib2j9uPBnz/Vzol8K7NNqoJ7n/PWSxLm+"
    "zJ/pqgfvn6rTU+Hz++N1BtR78z3fwxm8I/iC/QXfE+ulKH3GDGPD7CcmqPwc78hGHP44"
    "ivsmOzkD3+E1B9R7tGbinrH4nYqr9+0u9Pz+VMehT7JfmRA/iXfLP4vyfdbg9yvItyth"
    "PvufIL9maX5J+Ox/gvxjEj6/g4o/F+aXn2n+beGnRqQ/6v0RnBPsy3aELK4X+qpH14vj"
    "GfwGdX9x3Dal/uf99bWl9W8kzv3TE+jfa1q/pPXcP94f/nd+fuVXNN8Q/fn5O+fntP5Y"
    "7/9XXfxNHS9rfqqL/0jHDzS/T/v5+6jzj5jBb6GeDt4OtR9p5Ze9jqX8R7a/oPzJezrR"
    "/rJH+QmvaaHW7D9fKV/hNQa1f00rv+q1LeW/ty4WlD+vTp3o/e1R/jfEPwvzy0aYz741"
    "yFf+NsjfD/NVfwT47O+CfPYHn1W/cQ4rVHvL/iONdaBnzO9xTmLgcb9zDgVif/AEedrw"
    "2vCfnRz8S/0D4g3OYQX9E6OsibrtDbD/bPP8P6p+5BwK8N8x9X9brcI96zX5/Q7ylX9m"
    "/ojmlzT/hfDLJc0/Ej77D8V3NL8ifPuj8HPzwvfPNH9D8y3hp4Zb5J2xl74A330H9Wkp"
    "P2If7cMteE7uNuItt9NrXICO/X0L5/M79IXbht94MTOF+F238QX0q3QH/dBC3eFHTvfp"
    "j/DnufkW8nfxtl+gvxH/f9HC+fwO9XDxjtdLKaOLvyd8/xfNt8L83JzwbVP4V60wv2xo"
    "vi/8VDLMnyXhw/8o/pD5X+qnNcs="
)

_raw = zlib.decompress(base64.b64decode(_BLOB))
#: initial quad-row table (first two sample rows of the code-block)
VLC_TBL_INIT = struct.unpack("<1024H", _raw[:2048])
#: non-initial quad-row table
VLC_TBL_NONINIT = struct.unpack("<1024H", _raw[2048:])


def _build_enc(tbl):
    enc = {}
    for c in range(8):
        seen = set()
        for i in range(128):
            v = tbl[c * 128 + i]
            ln = v & 7
            cwd = i & ((1 << ln) - 1)
            if (cwd, ln) in seen:
                continue
            seen.add((cwd, ln))
            rho = (v >> 4) & 0xF
            u_off = (v >> 3) & 1
            e_1 = (v >> 8) & 0xF
            e_k = (v >> 12) & 0xF
            enc.setdefault((c, rho, u_off), []).append((ln, cwd, e_k, e_1))
    for k in enc:
        enc[k].sort()
    return enc


ENC_TBL_INIT = _build_enc(VLC_TBL_INIT)
ENC_TBL_NONINIT = _build_enc(VLC_TBL_NONINIT)

#: MEL coder state exponents E(k), k = 0..12 (T.814 Table 4)
MEL_E = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)
