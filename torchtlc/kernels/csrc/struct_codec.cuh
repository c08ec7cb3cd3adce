// Pack and unpack of struct-codec rows: the W-word wire form of a state's
// F fields, each field's bits LSB first in field order, fields spanning
// word boundaries (jaxtlc/struct/codec.py:290 pack, :315 unpack).  The
// table is the field widths, ST_WIDTHS, which the emitted spec header
// defines with ST_F and ST_W.
#pragma once
#include "common.cuh"

HD uint32_t st_lowmask(int take) {
  return take >= 32 ? 0xFFFFFFFFu : ((1u << take) - 1u);
}

HD void st_unpack(const uint32_t* __restrict__ w, int32_t* f) {
  const int widths[ST_F] = {ST_WIDTHS};
  int wi = 0, bitpos = 0;
  for (int j = 0; j < ST_F; j++) {
    uint32_t val = 0;
    int got = 0;
    while (got < widths[j]) {
      const int take = widths[j] - got < 32 - bitpos ? widths[j] - got
                                                     : 32 - bitpos;
      val |= ((w[wi] >> bitpos) & st_lowmask(take)) << got;
      got += take;
      bitpos += take;
      if (bitpos == 32) {
        wi++;
        bitpos = 0;
      }
    }
    f[j] = (int32_t)val;
  }
}

HD void st_pack(const int32_t* f, uint32_t* __restrict__ out) {
  const int widths[ST_F] = {ST_WIDTHS};
  uint32_t words[ST_W];
  for (int k = 0; k < ST_W; k++) words[k] = 0;
  int wi = 0, cur = 0;
  for (int j = 0; j < ST_F; j++) {
    uint32_t rem = (uint32_t)f[j];
    int rbits = widths[j];
    while (rbits > 0) {
      const int take = rbits < 32 - cur ? rbits : 32 - cur;
      words[wi] |= (rem & st_lowmask(take)) << cur;
      rem = take >= 32 ? 0u : rem >> take;
      rbits -= take;
      cur += take;
      if (cur == 32) {
        wi++;
        cur = 0;
      }
    }
  }
  for (int k = 0; k < ST_W; k++) out[k] = words[k];
}
