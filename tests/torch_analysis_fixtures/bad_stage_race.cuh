// Known-bad fixture for cuda-smem-race: fq2mul's schedule
// (field_coop.cuh's Fq2MulStages) with the Karatsuba finish moved into the
// stage of its products.  The finish's folds read t, which the other
// warps' products write in the same stage, before the block syncs; the
// host walk, spliced with this struct, differs from the plain version in
// both orders.  Spliced by tests/test_torch_analysis.py, never built alone.
struct Fq2MulStages {  // VIOLATION: the finish reads t in the stage that writes it
  Fq2Mul<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    Fq2Mul<NW>& r = *s;
    if (st == 0) {
      fold2_entry(c, r.in[0], r.f[0]);
      fold2_entry(c, r.in[1], r.f[1]);
    } else if (st == 1) {
      fq2mul_products(c, r.f[0], r.f[1], r.t);
      fq2mul_finish(c, r.t, r.out);
    }
  }
};
