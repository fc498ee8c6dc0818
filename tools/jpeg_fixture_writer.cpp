// The JPEG writer of tools/make_jpeg_data.py: raw interleaved samples in,
// one JPEG file out, written by libjpeg with the settings Pillow's save does
// not expose (the YCCK colour space, arithmetic coding with its DAC
// conditioning, hand-made progressive scan scripts, restart intervals in
// MCUs, any sampling factors, and, where the library has
// jpeg_enable_lossless, lossless frames).
//
//   g++ -O2 -o writer tools/jpeg_fixture_writer.cpp -ljpeg
//   writer in=raw w=W h=H incs=rgb|cmyk|gray jcs=ycbcr|rgb|cmyk|ycck|gray
//          out=file.jpg [q=75] [arith=1] [prog=1]
//          [scans="c,c:Ss-Se:Ah:Al;..."] [restart=MCUs] [restart_rows=N]
//          [samp="2x2,1x1,1x1"]
//          [dac="L,U,K"] [lossless="psv,pt"] [optimize=1]
//
// Built against libjpeg-turbo 2.1.5's jpeglib.h; jpeg_enable_lossless
// (libjpeg-turbo 3) is declared by hand and called only when lossless= is
// given, so the binary that writes lossless frames links a libjpeg-turbo 3.

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include <jpeglib.h>

extern "C" void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor, int point_transform)
    __attribute__((weak));

namespace {

struct Err {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr c) {
  char msg[JMSG_LENGTH_MAX];
  (*c->err->format_message)(c, msg);
  fprintf(stderr, "libjpeg: %s\n", msg);
  longjmp(reinterpret_cast<Err*>(c->err)->jump, 1);
}

J_COLOR_SPACE space(const std::string& s) {
  if (s == "rgb") return JCS_RGB;
  if (s == "cmyk") return JCS_CMYK;
  if (s == "ycck") return JCS_YCCK;
  if (s == "gray") return JCS_GRAYSCALE;
  return JCS_YCbCr;
}

}  // namespace

int main(int argc, char** argv) {
  std::map<std::string, std::string> a;
  for (int i = 1; i < argc; i++) {
    const char* eq = strchr(argv[i], '=');
    if (!eq) return 2;
    a[std::string(argv[i], size_t(eq - argv[i]))] = eq + 1;
  }
  const int w = atoi(a["w"].c_str()), h = atoi(a["h"].c_str());
  const J_COLOR_SPACE incs = space(a["incs"]);
  const int nin = incs == JCS_CMYK ? 4 : incs == JCS_GRAYSCALE ? 1 : 3;
  std::vector<unsigned char> px(size_t(w) * h * nin);
  FILE* f = fopen(a["in"].c_str(), "rb");
  if (!f || fread(px.data(), 1, px.size(), f) != px.size()) return 3;
  fclose(f);
  FILE* out = fopen(a["out"].c_str(), "wb");
  if (!out) return 4;

  jpeg_compress_struct c;
  Err err;
  c.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  if (setjmp(err.jump)) {
    fclose(out);
    return 5;
  }
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nin;
  c.in_color_space = incs;
  jpeg_set_defaults(&c);
  if (a.count("lossless")) {  // first: it sets the colour space of its own
    if (!jpeg_enable_lossless) return 6;
    int psv = 1, pt = 0;
    sscanf(a["lossless"].c_str(), "%d,%d", &psv, &pt);
    jpeg_enable_lossless(&c, psv, pt);
  }
  jpeg_set_colorspace(&c, space(a["jcs"]));
  jpeg_set_quality(&c, a.count("q") ? atoi(a["q"].c_str()) : 75, TRUE);
  if (a.count("samp")) {  // "2x2,1x1,1x1": h x v per component
    const char* p = a["samp"].c_str();
    for (int ci = 0; ci < c.num_components && *p; ci++) {
      c.comp_info[ci].h_samp_factor = atoi(p);
      p = strchr(p, 'x') + 1;
      c.comp_info[ci].v_samp_factor = atoi(p);
      while (*p && *p != ',') p++;
      if (*p) p++;
    }
  }
  if (a.count("arith")) c.arith_code = atoi(a["arith"].c_str()) != 0;
  if (a.count("optimize")) c.optimize_coding = atoi(a["optimize"].c_str()) != 0;
  if (a.count("dac")) {  // the same L, U and K for every table
    int L = 0, U = 1, K = 5;
    sscanf(a["dac"].c_str(), "%d,%d,%d", &L, &U, &K);
    for (int t = 0; t < NUM_ARITH_TBLS; t++) {
      c.arith_dc_L[t] = UINT8(L);
      c.arith_dc_U[t] = UINT8(U);
      c.arith_ac_K[t] = UINT8(K);
    }
  }
  if (a.count("restart")) c.restart_interval = atoi(a["restart"].c_str());
  if (a.count("restart_rows")) c.restart_in_rows = atoi(a["restart_rows"].c_str());
  if (a.count("prog") && atoi(a["prog"].c_str())) jpeg_simple_progression(&c);
  static std::vector<jpeg_scan_info> script;
  if (a.count("scans")) {  // "0,1,2:0-0:0:1;0:1-5:0:2;..."
    std::string s = a["scans"];
    size_t at = 0;
    while (at < s.size()) {
      size_t end = s.find(';', at);
      if (end == std::string::npos) end = s.size();
      std::string one = s.substr(at, end - at);
      jpeg_scan_info si;
      memset(&si, 0, sizeof(si));
      const char* p = one.c_str();
      while (*p != ':') {
        si.component_index[si.comps_in_scan++] = atoi(p);
        while (*p != ',' && *p != ':') p++;
        if (*p == ',') p++;
      }
      sscanf(p, ":%d-%d:%d:%d", &si.Ss, &si.Se, &si.Ah, &si.Al);
      script.push_back(si);
      at = end + 1;
    }
    c.scan_info = script.data();
    c.num_scans = int(script.size());
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px.data() + size_t(c.next_scanline) * w * nin;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  return 0;
}
