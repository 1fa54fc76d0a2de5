#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (heongpu_tpu_torch) on one GPU.

Drives the CKKS main path once at full width — N=2^16, twelve 29-bit Q
primes, Method-II keyswitching with alpha=4 (four 30-bit special primes, a
16-limb QP basis, 3 digits) — through the port's public entry points:
keygen, encode, encrypt, a chain of K=10 multiply -> relinearize, one
multiply -> relinearize -> rescale -> decrypt -> decode checked against
z·z[::-1], and a multiply -> relinearize at level 1.  Every keyswitch of one
poly runs K5, the fused keyswitch kernel.

Then drives the CKKS rotation path on the same context: Galois keys for
the steps 2^0..2^14 and conjugation, rotations (one step, a composed chain,
a negative step), conjugation, a rotate-and-sum over all 2^15 slots,
hoisted rotations (K1 and K2 base_conv / mac_keys), inverse-form keys, key
switching and a monomial product, each decoded against numpy.

Then drives the TFHE gate-bootstrapping path at full STD128 width (LWE
n=512, TRLWE N=1024, k=1, l=2, bg_bit=10, base-4 length-8 keyswitch): keys
from a seeded CUDA generator, the gates, NOT and MUX at B=64 against their
truth tables, huint8 add and sub, each with a BootKey (K3, the n-step chain)
and a BootKey2 (K4, the key-unrolled chain).

Then drives CKKS regular bootstrapping at full width: N=2^16, the
reference's depth-48 precision configuration (composite q0, alpha 4 with six
special primes: 54-limb QP bases and 12 digits, Taylor degree 9, six
squarings, the arcsine term), keys (about 30 GB) made on the card from a
seeded generator, one bootstrap of z ~ U(-0.5, 0.5) through mod_raise,
coeff_to_slot (hoisting on K1/K2, each giant step's diagonal MAC on K2
mac_keys, giant rotations on K5), eval_exp_sin twice and slot_to_coeff.

Then drives the bootstrapping variants at N=2^16 on the JAX package's v2
chain (nineteen primes, 25-limb QP bases): regular v2 (Chebyshev-cosine
EvalMod through poly_eval's baby-step/giant-step), slim, bit, the six gates,
regular v2 with the sparse-secret switch around the mod-raise, and regular
v2 in less-key mode (giant rotations composed from the power-of-two chain),
one key set at a time.

Then drives BFV at N=2^15 on the entry point's default chain (29 Q primes,
Method I) and at the repo's BFV bench shape (Method II), and CKKS with
Method-I keyswitching (the default of make_context) at N=2^16.

Then drives BGV at N=2^15 on the same 871-bit chain (29 Q primes and one
special prime, tc128): every division t-exact on K6's t-exact mode.  Phase 13
also bootstraps on the compressed depth-48 key set, whose stripped keys
regenerate their uniform halves with K7 (Threefry-2x32, bit-identical to
jax.random) at every use.

Then drives multiparty computation with three parties on Threefry keys
(rng.new_key, every draw jax.random's): BFV at N=2^15 on phase 15's default
chain and CKKS Method I at N=2^16 on phase 16's shape, through the
collective keys, threshold and t-of-N decryption and collective
bootstrapping; every Threefry bits draw on the card is one launch of K7's
raw-words mode.

Then drives the parallel layer: the coefficient-sharded NTT on K1's split
passes and the digit-sharded keyswitch on a one-rank NCCL group at the main
path's width, and bootstrap keys aligned for a 4-way limb mesh.

Then drives the host utilities (storage, memory, profiling) on the main
path's relinearization key, the native parameter engine at the main path's
N, and the limb-sharded CKKS step (multiply -> relinearize -> rescale ->
multiply -> relinearize on a ('dp', 'limb') mesh, keys placed by limb) on a
one-rank NCCL group at the main path's width, under both keyswitching
methods, on a batch of two.

Then drives the limb-sharded bootstrap (parallel/boot_sharded.py: mod_raise,
coeff_to_slot, eval_exp_sin, slot_to_coeff on limb-sharded ciphertexts, keys
placed by limb) on a one-rank NCCL group: tests/test_boot_sharded.py's
configuration at N=256, and phase 13's depth-48 bootstrap at N=2^16.

Then drives the bootstrapping variants on limb-sharded ciphertexts
(parallel/boot_ext_sharded.py: the Chebyshev EvalMod through a sharded
baby-step/giant-step, regular v2, slim, bit, the six gates, the sparse
switch, less-key mode) on a one-rank NCCL group: phase 14's v2 chain at
N=256 with limb_align=4 keys, and phase 14's regular v2 and NAND runs at
N=2^16.

Then drives stripped (seeded) keys on the limb-sharded paths (each rank
regenerates its own block of a key's uniform half: K7 over a row range of
the key's draw) at the main path's width, and the reference's key sets in
the port's loader on the card.

Phases (each raises on failure, so the script exits non-zero):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from heongpu_tpu_torch/kernels/csrc, and print
     the ptxas line (registers, stack, spills) of K3 and K4, of each of K5's
     nine shape instantiations, of K1's four pass kernels at each of its
     nine shapes (whole and split: 72), of K2 base_conv's 18 (each chunk width 4..32 and the
     chunked one for k_in > 32, with and without the fused scaling) and of
     K6's in each of its two modes (the tile kernel at p = 1..16, the
     whole-column kernel for k <= 16 Q limbs at p = 1..8), and
     of K7's two modes; a missing line, or a K1, K2, K5, K6 or K7 instance that
     spills, fails; the SASS mix (cuobjdump) of K7's two modes, which must hold
     the funnel shifts and xors their bounds count for each of the words a
     thread computes;
  3. K1 (NTT) against its plain torch version on the card, bit for bit,
     forward and inverse, N in {2^8, 2^9, 2^11, ..., 2^16} (2^10 in phase 8):
     each of its nine shape instantiations;
  4. K2 (keyswitch MAC, base conversion with and without the fused
     scaling, also at 5 -> 3, 14 -> 16 and 62 -> 64) and K6 (the ÷P chain: a
     keyswitch's at levels 0 and 1, the encryption's, one stage, 8 stages, 20
     stages in two launches; its t-exact mode at one stage over 29 + 1 limbs
     at N=2^15, 3 stages and 20) and K7 (a public key's row over 30 limbs at
     2^15, three rows moved behind 16 limbs; its raw-words mode at 5, 21000 and
     2^22 words) against the plain versions; K5 (fused
     keyswitch) against keyswitch2_fused_core_plain and against the staged
     route (K2 base_conv, K1, K2 mac_keys, K1) at N=2^12 and at N=2^16,
     levels 0 and 1 (a short last digit group at level 1);
  5. the CKKS main path, with launch counts reset just before it and read
     just after (ntt_fwd, ntt_inv and keyswitch2_fused must launch); every
     kernel launch of it at a new input shape is held against the plain
     version on the same inputs right after it returns
     (held_against_plain); the residues of one multiply -> relinearize ->
     rescale must equal the CPU (plain path) run on copies of the same keys
     and inputs;
  6. the CKKS rotation path, counts reset just before and read just after
     (keyswitch2_fused, mac_keys, base_conv, ntt_fwd and ntt_inv must
     launch), held against plain as in phase 5; each result decoded within
     TOL_DECODE plus the noise of the keyswitches it went through
     (keyswitch_noise), the rotate-and-sum within TOL_SUM; one rotate and one
     rotate_hoisted on the CPU plain path must equal the card's residues;
  7. timings with CUDA events: the K=10 chain as ops/s, each kernel against
     its plain version at the main-path shapes (K1 at the hoisting shapes
     (3, 16, 2^16) forward and (2, 16, 2^16) inverse, and at the main path's
     (12, 2^16) both ways and (2, 12, 2^16) forward, each with the device
     time of its two passes from torch.profiler; K5 at levels 0 and 1, each
     beside the staged route of K2 and K1 on the same inputs and the ratio
     of the two), rotate, rotate_hoisted and the rotate-and-sum; the
     device-idle share of one mult+relin and of one rotate from
     torch.profiler;
  8. K1 on the TFHE table (N=1024, 2 limbs; 8 and 512 rows), and timed both
     ways at 32 rows (B=8 gates, 2 polys) as in phase 7; the STD128
     context and keys, with keygen's K1 launches held against plain as in
     phase 5; K3 and K4 against the plain chains at B=8, bit for bit;
  9. the TFHE main path, with launch counts reset just before it and read
     just after: blind_rotate, blind_rotate2, ntt_fwd and ntt_inv must
     each have launched, and each launch at a new shape (B=64 gates, the
     2B=128 MUX, every batch size of the huint8 rounds) is held against
     plain as in phase 5; one bootstrap per key kind on the CPU plain path
     (copies of the same keys and ciphertext, B=2) must equal the card's;
 10. TFHE timings with CUDA events (NAND at B=8 and B=64 against the plain
     chain on the card, K3/K4 against the plain chains, each output
     compared, with their microseconds per step and their per-SM bound,
     huint8 add and MUX at B=64) and, from torch.profiler, the
     device-idle share and the leading kernels of NAND at B=8 and B=64 and
     of a huint8 add.
 11. bootstrap (a): N=256 in the precision configuration of
     tests/test_ckks_boot.py, keys and pieces built on the CPU and moved to
     the card; one regular_bootstrap on the card (every kernel launch at a
     new shape held against plain) must equal the CPU plain path's residues,
     and decode within 3e-5 of z; (a') the same on the compressed key set
     (K7 once per stripped-key use on the card);
 12. bootstrap (b): depth 48 at N=2^13, keys on the card, within 3e-5 (the
     reference's one valid on-chip point read 1.7e-7); the errors between
     the phases (mod_raise overflow, CtoS, EvalMod) printed;
 13. bootstrap (c), the main path: depth 48 at N=2^16, launch counts reset
     just before one bootstrap and read just after (ntt_fwd, ntt_inv,
     keyswitch2_fused, mac_keys and base_conv must launch), every launch at
     a new shape held against plain as it happens; max and p99 error against
     z within 3e-5 (above it the errors between the phases are printed
     before the script fails); key-generation time and resident bytes; the median
     of 3 bootstraps and of each phase (CUDA events), the device busy time
     and idle share (torch.profiler); K5, mac_keys and base_conv timed at
     the bootstrap's new shapes.  (c') the same bootstrap on the compressed
     key set (compress_keys=True, keys from a seeded generator, the same
     context and secret key): key bytes against the full set's, keygen
     seconds, no two keys sharing a Threefry key (a_seed mod 2^32; the
     reference's seed layout collides there), launches counted from 0 and held against plain
     (K7 must launch, once for each stripped-key use counted in ensure_k1 and
     predicted by stripped_key_uses), the error within 3e-5, the median of 3,
     busy and idle share, one regenerated k1 equal to the CPU's plain
     Threefry, K7 timed at the largest key's shape.
 14. the bootstrapping variants on the JAX package's v2 chain (29-bit q0,
     eighteen 28-bit primes, alpha 4 with six special primes: 25-limb QP
     bases, 5 digits, the last one partial; Chebyshev cosine of degree 24,
     five double angles, K=12, 2 + 2 pieces, secret hw 16): (a) N=256, keys
     made on the CPU and moved to the card, regular v2, slim, bit, the six
     gates, regular v2 with the sparse-secret switch and in less-key mode:
     each output's residues on the card must equal the CPU's, and each error
     must be within TOL_V2 (the JAX package's limits at this size); (b) the
     same runs at N=2^16, one key set at a time on the card (key bytes and
     keygen seconds printed), each run's launches counted from 0 (ntt_fwd,
     ntt_inv, keyswitch2_fused, mac_keys and base_conv must launch), every
     launch at a new shape held against plain as it happens, its max and p99
     error over all 2^15 slots printed, bit and the gates within
     TOL_V2_FULL; regular v2's EvalMod, the sparse-switch raise and a
     composed less-key-mode rotation must equal the CPU plain path's
     residues; regular v2's errors between the phases printed; regular,
     slim, bit, NAND and less-key mode timed (median of 3, CUDA events
     around StoC, the raise, CtoS and EvalMod) with the device busy time and
     idle share, the regular run's device time by step, and the less-key
     set's Galois keys and time against the standard set's.
 15. BFV: (a) N=256, both methods, every entry point and BFV gate on the card
     against the CPU plain path (keys and randomness from one DRBG seed on
     both sides: identical residues, noise budgets within 1e-6); (b) N=2^15
     on bfv.make_context's default chain (Method I), launches counted from 0
     (ntt_fwd, ntt_inv, mac_keys and base_conv must launch), every launch at a
     new shape held against plain: mult -> relin -> decrypt exactly the
     slot-wise product mod t, rotate_rows by 1, rotate_columns and hoisted
     rotations exact, the noise budget > 0, mult+relin and a rotation equal
     to the CPU plain path's; per-op medians (CUDA events), device busy and
     idle share, key bytes; (c) N=2^15 at benchmarks/benchmark_bfv.py's shape
     (eight 29-bit Q primes, Method II, alpha 2: K5 in the coefficient
     domain), counted and held as in (b), its rows (encrypt, add, multiply,
     mult+relin, rotate, decrypt) as medians of 10 calls;
 16. CKKS with Method-I keyswitching at the main path's shape (twelve 29-bit
     Q primes, one special prime, 12 digits), counted from 0 (ntt_fwd,
     ntt_inv and mac_keys must launch) and held against plain:
     mult -> relin -> rescale within TOL_DECODE, rotate by 1, rotate_hoisted
     and conjugate within TOL_DECODE + 4·keyswitch_noise; mult+relin+rescale,
     rotate and rotate_hoisted equal to the CPU plain path's; per-op medians,
     device busy and idle share, key bytes.
 17. BGV: (a) N=256 on tests/test_bgv.py's chain, every entry point on the
     card against the CPU plain path (DRBG keys on both sides, a seeded relin
     key used stripped: identical residues, levels and factors); (b) N=2^15 on
     the 871-bit chain: 8 squarings (multiply -> relinearize -> 2 x
     mod_switch), rotate_rows by 1, multiply_plain, add_plain, each op's
     launches held to BGV_OP_LAUNCHES, every launch at a new shape held
     against plain, decrypted exactly against numpy mod t, the noise budget
     after each step; per-op medians, busy and idle share, key bytes; K6's
     t-exact mode and K7 timed at BGV's shapes.
 18. MPC, three parties, every key, share and mask from Threefry keys:
     (a) N=256, every MPC entry point of both schemes (BFV on [29]*3 with
     t = plain_modulus_for(256, 16), CKKS on [29, 25, 25, 25]; 3-of-5 and
     2-of-3 Shamir) and the new draws at (2^16,) (randint, normal,
     permutation in two sort rounds, gaussian_rns, ternary_hw, a fold_in key's
     bits) on the card against the CPU plain path: identical residues, normal
     within 1e-6, every decryption exact or within 5e-2; (b) BFV at N=2^15 on
     phase 15's default chain: collective public key, 2-round relin key, a
     collective Galois key, encrypt -> multiply -> relinearize -> rotate_rows
     by 1, threshold decryption, collective bootstrap and decryption again,
     3-of-5 Shamir decryption by parties (2, 4, 5), all exact; the noise
     budget under the oracle joint key Σ s_i before and after the collective
     bootstrap (after must be larger); (c) CKKS Method I at N=2^16 on phase
     16's shape: the same with rescale, the collective bootstrap to level 0
     and 2-of-3 Shamir, each decoded within 5e-2 (the max error printed).  In
     each, launches counted from 0, every launch at a new shape held against
     plain, K6 once per ÷P site, no plain Threefry pass on the card
     (plain_threefry_on_card), and each protocol step's K7 launches (uniform,
     words) equal to mpc_k7_predicted's; ms per protocol step (median of 3),
     device busy and idle share of a threshold decryption and of a
     collective bootstrap, the collective keys' bytes, and K7's raw-words
     mode timed at (k, N) and (N,) against its bound.
 19. the parallel layer (heongpu_tpu_torch/parallel) at the main path's
     width: (a) K1's split entry (hf_ntt_pass) at D = 2, 4 and 8 ranks on 12
     and 16 rows of 2^16, every rank's two passes with the exchange done in
     process, equal to K1 whole bit for bit, every launch held against plain;
     the device ms of a split transform against K1 whole, and each pass timed
     against its bound; (b) a one-rank NCCL group (init_process):
     make_sharded_ntt on a one-rank 'coef' mesh equal to ntt_fwd / ntt_inv,
     and keyswitch2_sharded on make_mesh(1) at the bench shape equal to
     keyswitch2 through K5, launches counted from 0
     (ntt_pass, base_conv, mac_keys and div_round must launch, keyswitch2_fused
     must not), its device ms against K5's; one rank runs no exchange on the
     card; (c) limb_align=4 keys at phase 11's N=256 configuration: every key's
     limb extent divides 4, and the bootstrap's residues on the card equal the
     CPU's.
 20. the host utilities, the native engine and the limb-sharded CKKS step
     (heongpu_tpu_torch/utils/{storage,memory,profiling,native}.py,
     parallel/ckks_sharded.py): (a) the main path's relin key parked by
     to_host and brought back by to_device (storage_of DEVICE, HOST, DEVICE),
     mult+relin on it identical; device_pool_status's bytes in use equal to
     torch.cuda.memory_allocated; time_op; a profiling.trace file that holds
     the K5 launch; a device_memory_profile snapshot; (b) the native engine
     built with g++ (its absence fails), its primes, roots and NTT tables at
     N=2^16 equal to the pure-Python path's; (c) on a one-rank NCCL group at
     the main path's width, Method II and phase 16's Method I, a batch of 2
     placed by ct_sharding(batched) and the key by shard_pytree_limb_axis:
     mult -> relin -> rescale -> mult -> relin equal to the unsharded entry
     points on each pair, launches counted from 0 and held against plain,
     keyswitch2_fused never, div_round once a relinearize; device busy and
     wall ms of one mult+relin+rescale sharded against unsharded.  One rank
     runs no exchange on the card: the gloo tests hold the exchanges.
 21. the limb-sharded bootstrap (parallel/boot_sharded.py) on a one-rank
     NCCL group, keys placed by shard_pytree_limb_axis: (a) N=256,
     tests/test_boot_sharded.py's configuration with limb_align=4 keys made
     on the CPU: the card's sharded coeff_to_slot and regular_bootstrap equal
     to the CPU plain path's unsharded results, K5 never launched; (b) phase
     13 (c)'s depth-48 bootstrap at N=2^16 on its keys and input made again
     from its seed, launches counted from 0 and held against plain, K5 never
     launched, K6 once a ÷P site: residues equal to phase 13 (c)'s output,
     error within 3e-5; the bytes the placement adds, the peak
     memory_allocated against phase 13 (c)'s, device busy, wall and idle
     share against the unsharded bootstrap's; (c) (a)'s keys are a
     compressed set that (a) runs whole: the sharded regular_bootstrap on
     the same keys stripped equals (a)'s residues, K7 once a stripped-key use
     (stripped_key_uses); a plain-tensor ciphertext raises TypeError, keys
     stripped with no seed ParameterError.
 22. the bootstrapping variants on limb-sharded ciphertexts
     (parallel/boot_ext_sharded.py) on a one-rank NCCL group, keys placed by
     shard_pytree_limb_axis: (a) N=256, phase 14's v2 configuration with
     limb_align=4 keys made on the CPU: every run of phase 14 (regular,
     slim, bit, the six gates, the sparse switch, less-key mode) sharded on
     the card, its residues, level and scale equal to the CPU plain path's
     unsharded result, K5 never launched; (b) phase 14 (b)'s regular v2 and
     NAND runs at N=2^16 (tools/chip_phase22.py adds less-key mode) on their
     keys made again from phase 14's generator state, one ~9 GB set at a
     time, launches counted from 0 and held against plain, K5 never
     launched, K6 once a ÷P site: residues, level and scale equal to phase
     14 (b)'s outputs, NAND's error within 0.1; the launches against the
     staged route's rule (each K5 launch of phase 14's run becomes one more
     K1 forward, K1 inverse and mac_keys and a base_conv a digit), the bytes
     the placement adds, peak memory_allocated, device busy, wall and idle
     share against the unsharded run's; (c) (a)'s regular set is a
     compressed one that (a) runs whole: regular v2 sharded on the same keys
     stripped equals (a)'s output, K7 once a stripped-key use; a plain-tensor
     ciphertext raises TypeError, a set stripped with no seeds ParameterError.
 23. stripped keys on the sharded paths and the reference's key sets in the
     loader: (a) K7's row range on the card over the depth-48 key's 54 QP
     limbs, a (12, 2^16) draw moved and in Montgomery form: each block of a
     4-way split (14, 14, 14, 12 rows) and rows 13..40, equal to the plain
     version's row range on the card and to the same rows of K7's whole
     draw; the whole draw and a rank's block timed; (b) on a one-rank NCCL
     group at the main path's width, a seeded relin key and Galois key
     (seeds below 2^32 and apart) stripped and placed by
     shard_pytree_limb_axis: multiply -> relinearize -> rescale -> rotate by 1,
     launches counted from 0 and held against plain, K7 once a stripped-key
     use (2), K5 never, K6 once a ÷P site; every result equal to the
     unsharded entry points' on the same stripped keys and on the keys
     whole, the rotation decoded within TOL_DECODE + 4·keyswitch_noise; a
     stripped key with no seed raises ParameterError; (c) a compressed
     BootKeysV2 (phase 14's chain at N=256, made on the CPU) and a TFHE
     BootKey (STD128, made on the card) written by the port's serializer in
     the reference's format and loaded onto the card: regular v2 (unsharded,
     and sharded on the placed set) and NAND at B=64 on them equal to the
     runs on the keys interop builds from their numpy arrays, the cosine
     coefficients float64.  tools/chip_phase23.py runs the depth-48 bootstrap
     on phase 13 (c')'s compressed set sharded on one rank, against the
     unsharded output.
On every path the calls that end in one ÷P on the card (div_round_sites:
each keyswitch, each keyswitch finish, each encryption, each BGV mod
switch) are counted, and the path fails unless K6 launched once for each.  Phase 7 also times K2
mac_keys and base_conv 4 -> 16 (both forms) and K6 on a keyswitch's halves,
phase 13 base_conv 4 -> 54 and K6 over the 54-limb basis (p = 6), phase 15
base_conv 29 -> 32 (B = 2 and 3) and 31 -> 29 (both forms) and K6 with one
stage; the last lines before the record give the device busy time and idle
share of the main calls.
The kernels' max_abs_err is the worst over every comparison above.  Each
kernel's bound_ms is the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and a lower count of its int32
operations over the card's int32 rate, from this run's timed inputs; K3 and
K4 also carry per_sm_bound_ms, the operations of one gate's chain over one
SM's share (1/132) of that rate, since each gate runs on one SM.
The last three lines are the kernels' JSON record, the card line and
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py   (one CUDA device; no arguments)
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

N = 1 << 16
Q_BITS = [29] * 12
ALPHA = 4
K_CHAIN = 10
# Decode limit for z*z[::-1] at this shape.  The fresh-encryption noise sets
# the floor: per coefficient 3.2*sqrt(hw + 2N/3) ~ 885 (hw = N/2), per slot
# component 885*sqrt(N/2)/scale ~ 3.1e-4 at scale ~ 2^29, so the product of
# two fresh ciphertexts has a max error over the 2^15 slots near 2e-3.  The
# limit leaves 2.5x over that floor; exactness is held by the bit-identical
# comparison with the CPU plain path.
TOL_DECODE = 5e-3
# Rotate-and-sum limit: the slot sum carries (N/2)·e0/scale of the fresh
# noise, std about 2^15 · 885 / 2^29 ~ 0.054 (885 from the formula above), so
# 0.5 is about 9 sigma; exactness is held by the bit-identical comparison.
TOL_SUM = 0.5
# The level-1 square doubles the relative error of its input.
TOL_DECODE_L1 = 2 * TOL_DECODE
# A result that went through k keyswitches (rotations, conjugation, key
# switching) is held to TOL_DECODE + 4·sqrt(k)·keyswitch_noise(ctx): see there.
GAUSS_SIGMA = 3.2
# Bootstrapping: the reference's depth-48 precision configuration (composite
# q0 of two 29-bit primes, 46 28-bit scale primes, alpha 4 with six special
# primes: 54-limb QP bases, 12 digits; Taylor degree 9, six squarings, the
# arcsine term, pieces at the composite scale), at N=2^13 and N=2^16, hw 32.
BOOT_Q_BITS = [29, 29] + [28] * 46
BOOT_CTX = dict(scale_bits=28, ks_type="II", alpha=4, p_count=6)
BOOT_CFG = dict(taylor_degree=9, exp_squarings=6, base_count=2, arcsin_order=1, piece_depth=2,
                ctos_pieces=2, stoc_pieces=2)
BOOT_HW = 32
# and the N=256 precision configuration of tests/test_ckks_boot.py
PREC_Q_BITS = [29, 29] + [28] * 42
PREC_CTX = dict(scale_bits=28, ks_type="II", alpha=2, p_count=4)
PREC_CFG = dict(taylor_degree=9, exp_squarings=5, base_count=2, arcsin_order=1, piece_depth=2)
# The reference's regression limit for the precision configuration (it
# measured 4.42e-6 at N=256 and 1.7e-7 at N=2^13, depth 48), held at every
# size the bootstrap runs, N=2^16 included (the JAX package's broken N=2^16
# runs read 0.50 and 1.9).
TOL_BOOT_PRECISE = 3e-5
TFHE_B = 64        # gates per batch on the TFHE main path
HUINT_COUNT = 8    # huint8 integers per add: 64 bit ciphertexts
GATES = {"NAND": lambda a, b: ~(a & b), "AND": lambda a, b: a & b,
         "OR": lambda a, b: a | b, "NOR": lambda a, b: ~(a | b),
         "XOR": lambda a, b: a ^ b, "XNOR": lambda a, b: ~(a ^ b)}


# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth, and the
# int32 rate as the published float32 rate over 4 (an FMA counts as 2 flops,
# and an SM has 64 INT32 lanes against 128 FP32 lanes).  An SM issues one warp
# instruction per scheduler and clock, 128 lanes: an integer add can issue on
# the FMA pipe (IMAD.IADD) beside a shift or logic op on the ALU pipe, whose 64
# lanes are INT32_OPS_PER_S.  K7's bound counts both limits (bound's alu_ops).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
ISSUE_OPS_PER_S = 2 * INT32_OPS_PER_S
SMS = 132           # SMs of an H100 SXM; K3/K4 run one gate on one SM
# Lower counts of int32 instructions per unit of work, for the bounds.
BUTTERFLY_OPS = 6   # Shoup butterfly: a*w, umulhi(a, w'), the -q*p multiply-add, add, sub, select
SHOUP_OPS = 3       # Shoup product by a table constant
MAC_OPS = 2         # 32x32 -> 64-bit multiply-accumulate
FOLD_OPS = 10       # REDC of a 64-bit sum with the Barrett pre-reduction
DIV_OPS = 2 + SHOUP_OPS  # one ÷P stage on a word: add the rounding constant, subtract r, Shoup
# one t-exact stage on a word: the Shoup product t·|v|, its fix-up and sign, the
# addition, the Shoup product by q_last^-1 and its fix-up
EXACT_OPS = 2 * SHOUP_OPS + 4
# one word of K7: two Threefry-2x32 hashes (20 rounds of add, funnel shift and xor,
# five key injections of two adds, the counter add and the closing xor), the high
# word's lazy Shoup product by 2^32 mod p and the low word's lazy Barrett reduction
# (SHOUP_OPS and 2), their sum, and two conditional subtractions, a = min(a, a - m)
# of 2 each; in Montgomery form a Shoup product takes the place of the first
# subtraction.  Of these only the ALU pipe runs the hashes' funnel shifts (SHF.L.W)
# and xors (LOP3) and the min of each conditional subtraction: THREEFRY_ALU_OPS.
THREEFRY_OPS = 2 * (20 * 3 + 5 * 2 + 2) + SHOUP_OPS + 2 + 1 + 2 * 2
THREEFRY_ALU_OPS = 2 * (20 * 2 + 1) + 2
# what the Montgomery form changes in those counts: a Shoup product for an add and a min
MONT_OPS = SHOUP_OPS - 2
MONT_ALU_OPS = -1
# one word of K7's raw-words mode: one hash (as above); of its operations the 20
# funnel shifts and 21 xors run on the ALU pipe only
THREEFRY_WORD_OPS = 20 * 3 + 5 * 2 + 2
THREEFRY_WORD_ALU_OPS = 20 * 2 + 1


def nbytes(*ts) -> int:
    """Bytes of the tensors; a stripped key half (None) holds none."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(nbytes_: int, ops: float, alu_ops: float = None):
    """(least ms, "bytes" or "operations") for moving nbytes_ and doing ops,
    at INT32_OPS_PER_S; or, given the alu_ops of them that only the ALU pipe
    runs, the larger of those at INT32_OPS_PER_S and all ops at the issue
    rate."""
    o_ms = (ops / INT32_OPS_PER_S if alu_ops is None
            else max(alu_ops / INT32_OPS_PER_S, ops / ISSUE_OPS_PER_S)) * 1e3
    b_ms = nbytes_ / HBM_BYTES_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def transform_ops(rows: int, n: int) -> int:
    """Butterflies and cross-twiddle products of `rows` n-point transforms."""
    return rows * (n // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS + n * SHOUP_OPS)


def ntt_tables(tb, inverse: bool):
    """The tables K1 reads for one direction: the cross twiddles and the packed
    stage tables, each with its Shoup companion."""
    pre = "itw" if inverse else "tw"
    return tuple(getattr(tb, pre + k) for k in ("_mat", "_mat_sh", "1p", "1p_sh", "2p", "2p_sh"))


def ptxas_summary(log: str, kernel: str) -> dict:
    """{function: its ptxas line of registers and spills} for the functions
    whose (mangled) name holds `kernel`, from the `nvcc -Xptxas -v` build log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if m:
            name = m.group(1)
        elif name and kernel in name and ("spill" in line or "registers" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def sass_mix(lib, kernel: str) -> dict:
    """{opcode with its modifiers: count} of the SASS of the function whose
    (mangled) name holds `kernel` in the built library, from `cuobjdump -sass`."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    mix, inside = {}, False
    for line in sass.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            inside = kernel in m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            mix[m.group(1)] = mix.get(m.group(1), 0) + 1
    if not mix:
        raise AssertionError(f"no SASS for {kernel} in {lib}")
    return mix


def fmt_ms(x) -> str:
    """A measured time (or share) for printing; None is a time not measured."""
    return "not measured" if x is None else f"{x:.4f}"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def rand_residues(primes, shape, gen, device):
    import torch
    p = torch.tensor(primes, dtype=torch.int64, device=device).view(-1, 1)
    x = torch.randint(0, 1 << 62, shape, generator=gen, device=device, dtype=torch.int64)
    return torch.remainder(x, p).to(torch.int32)


def max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_idle_share(fn, reps: int, tries: int = 3, counts: dict = None):
    """(busy ms, wall ms, idle share, {kernel: ms}) per call of fn, over `reps`
    calls (and, given `counts`, the number of each kernel's events in the
    trace put there).  Busy is the union of the device events' intervals in a
    torch.profiler trace (only events on the card: a host op's self device
    time repeats its kernels'); wall is the host clock around an unprofiled,
    synchronized run.  The profiler's device tracing sometimes delivers no
    event at all; the trace is then taken again, up to `tries` times, and if
    none holds a device event, busy and idle are None (not measured) and the
    per-kernel dict is empty.  These are measurements only: what the kernels
    launched and computed is checked elsewhere."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        if evts:
            break
        print("  torch.profiler recorded no device event; tracing again")
    else:
        print(f"  torch.profiler recorded no device event in {tries} traces: "
              "device time not measured")
        return None, wall, None, {}
    busy_us, end, per_kernel = 0.0, float("-inf"), {}
    for e in sorted(evts, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        if t > end:
            busy_us += t - max(s, end)
            end = t
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (t - s) / 1e3 / reps
        if counts is not None:
            counts[e.name] = counts.get(e.name, 0) + 1
    busy = busy_us / 1e3 / reps
    return busy, wall, 1.0 - busy / wall, per_kernel


# The port's kernel functions (the anonymous namespaces of kernels/csrc/*.cu) as
# torch.profiler names them: base_conv_kernel<Kin, scaled> and
# div_round_{column,tile}_kernel<p, exact> are K2's and K6's templates.
OWN_KERNEL = re.compile(r"\(anonymous namespace\)::((?:ntt_(?:fwd|inv)[12]|mac_keys_kernel|"
                        r"base_conv_kernel|div_round_(?:column_|tile_)?kernel|keyswitch2_fused_kernel|"
                        r"blind_rotate_kernel|threefry_uniform_kernel|threefry_bits_kernel)"
                        r"(?:<[^>]*>)?)\(")


def own_kernels(per_kernel: dict) -> dict:
    """{port kernel function: device ms per call} out of device_idle_share's
    per-kernel times."""
    out = {}
    for name, ms in per_kernel.items():
        if m := OWN_KERNEL.search(name):
            out[m.group(1)] = out.get(m.group(1), 0.0) + ms
    return out


def kernels_per_call(fn):
    """(fn's result, how many of the port's kernels one call of fn launches):
    each wrapper's count times the kernels that count stands for
    (KERNELS_PER_COUNT)."""
    from heongpu_tpu_torch import kernels
    before = dict(kernels.launches)
    got = fn()
    return got, sum(KERNELS_PER_COUNT.get(k, 1) * (v - before.get(k, 0))
                    for k, v in kernels.launches.items())


def traced_device_ms(fn, reps: int = 5, per_call: int = None, tries: int = 3):
    """(device ms per call of the port's kernels in fn, {kernel: ms}, launches
    traced, launches made) over a torch.profiler trace of `reps` calls.  The
    profiler may drop a trace's events: while the trace holds fewer of the
    port's launches than the calls made (per_call a call, counted by the
    wrappers through kernels_per_call when not given), fn is traced again, up
    to `tries` traces; the trace with the most launches is kept and its times
    are scaled by made / traced.  (None, {}, 0, made) where no trace holds
    one."""
    if per_call is None:
        per_call = kernels_per_call(fn)[1]
    made, own, traced = reps * per_call, {}, 0
    for _ in range(tries):
        counts = {}
        got = own_kernels(device_idle_share(fn, reps, counts=counts)[3])
        n = sum(c for k, c in counts.items() if OWN_KERNEL.search(k))
        if n > traced:
            own, traced = got, n
        if traced >= made:
            break
    if not own or not traced:
        return None, {}, traced, made
    scale = max(1.0, made / traced)
    return sum(own.values()) * scale, {k: v * scale for k, v in own.items()}, traced, made


def dropped_note(traced: int, made: int) -> str:
    """' (k of m launches traced)' where the profiler dropped launches."""
    return f" ({traced} of {made} launches traced)" if 0 < traced < made else ""


def mac_keys_plain(d, k0, k1, base):
    """The plain version of K2's mac_keys."""
    import torch
    from heongpu_tpu_torch.ops import rns
    return torch.stack([rns.lazy_mac_mont(d, k0, base), rns.lazy_mac_mont(d, k1, base)])


# How many kernels one count of a wrapper in kernels.launches stands for: a K1
# transform (ntt_fwd, ntt_inv) is its two pass kernels (kernels/csrc/ntt.cu,
# hf_ntt), every other count one kernel.
KERNELS_PER_COUNT = {"ntt_fwd": 2, "ntt_inv": 2}


def kernel_wrappers():
    """(module, wrapper name, kernel name from its arguments, plain version)
    for every kernel wrapper of the port."""
    from heongpu_tpu_torch.models import tfhe
    from heongpu_tpu_torch.ops import keyswitch_fused as ksf
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.ops import rns
    from heongpu_tpu_torch.ops import tfhe_kernel as tk
    from heongpu_tpu_torch.utils import threefry
    return [
        (threefry, "uniform_rns_cuda", lambda *a: "threefry_uniform", threefry.uniform_rns_plain),
        (threefry, "bits32_cuda", lambda *a: "threefry_bits", threefry.bits32_plain),
        (nttm, "ntt_cuda", lambda x, tb, inverse: "ntt_inv" if inverse else "ntt_fwd",
         lambda x, tb, inverse: (nttm.ntt_inv_plain if inverse else nttm.ntt_fwd_plain)(x, tb)),
        (nttm, "ntt_pass_cuda", lambda *a: "ntt_pass", nttm.ntt_pass_plain),
        (rns, "mac_keys_cuda", lambda *a: "mac_keys", mac_keys_plain),
        (rns, "base_conv_cuda", lambda *a: "base_conv", rns.base_conv_plain),
        (rns, "div_round_cuda", lambda x, chain: "div_exact_t" if chain.exact_t else "div_round",
         rns.div_round_chain_plain),
        (ksf, "keyswitch2_fused_cuda", lambda *a: "keyswitch2_fused",
         ksf.keyswitch2_fused_core_plain),
        (tk, "blind_rotate_cuda",
         lambda acc, a_t, key, ctx, unrolled=False: "blind_rotate2" if unrolled else "blind_rotate",
         lambda acc, a_t, key, ctx, unrolled=False:
             (tfhe.blind_rotate2_plain if unrolled else tfhe.blind_rotate_plain)(acc, a_t, key, ctx)),
    ]


def held_shape(arg):
    """What tells a kernel's launches apart beside its tensors' shapes: a
    tensor's shape, and a ÷P chain's stage count (K6's template)."""
    import torch
    from heongpu_tpu_torch.ops import rns
    if isinstance(arg, torch.Tensor):
        return tuple(arg.shape)
    return ("stages", len(arg)) if isinstance(arg, rns.DivRoundChain) else None


def launch_shapes(name, args):
    """The shapes that tell a kernel's launches apart: K7's prime count, draw
    shape, flags and row range (its key is data), its raw-words mode's draw shape, a K1
    split pass's input shape, direction, pass, ranks and rank, every other
    kernel's held_shape of each argument."""
    if name == "threefry_uniform":
        _, primes, shape, _, moved, mont, *rows = args
        return (len(primes), tuple(shape), moved, mont, *rows)
    if name == "threefry_bits":
        return (tuple(args[1]),)
    if name == "ntt_pass":
        return (tuple(args[0].shape),) + tuple(args[2:])   # direction, pass, ranks, rank
    return tuple(held_shape(a) for a in args if held_shape(a) is not None)


@contextlib.contextmanager
def held_against_plain(what, errs):
    """Runs the block with every kernel wrapper wrapped so that the first launch
    at each distinct set of input shapes is held against the plain version on
    the same inputs right away: the kernels are checked at exactly the shapes,
    and on the data, that the block gave them, and nothing is kept.  The worst
    error goes into errs[kernel]; any difference raises.  Prints one line per
    kernel when the block ends."""
    import torch
    saved, checked = [], {}
    for mod, attr, namer, plain in kernel_wrappers():
        def recorded(*args, _fn=getattr(mod, attr), _namer=namer, _plain=plain):
            out = _fn(*args)
            name = _namer(*args)
            shapes = launch_shapes(name, args)
            seen = checked.setdefault(name, {})
            if shapes not in seen:
                seen[shapes] = e = max_err(out, _plain(*args))
                errs[name] = max(errs[name], e)
                if e:
                    raise AssertionError(f"{name} disagrees with its plain version at a "
                                         f"{what} shape {shapes}")
            return out
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, recorded)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    if not checked:
        raise AssertionError(f"{what} launched no kernel")
    for name, seen in sorted(checked.items()):
        print(f"{name}: {len(seen)} {what} shapes held against plain, "
              f"max err={max(seen.values())}")


# The functions that end in exactly one ÷P each, so in one K6 launch when they
# run on the card: a keyswitch of either route (Method II), a keyswitch finish
# (Method I's keyswitch_core, the hoisted and accumulated finishes of both
# methods: ckks.ks_finish_at, BFV's hoisted rotations and BGV's keyswitch call
# it), an encryption, BGV's mod switch (K6's t-exact mode, as BGV's other
# divisions), and the sharded ops' ÷P tail (every sharded keyswitch and
# ks_finish_at ends in it).  (module, function).
DIV_ROUND_SITES = (("ops.keyswitch2", "keyswitch2"), ("models.ringkit", "ks_finish"),
                   ("models.ckks", "_encrypt_zero_ntt"), ("models.bfv", "encrypt"),
                   ("models.bgv", "encrypt"), ("models.bgv", "mod_switch"),
                   ("parallel.keyswitch_sharded", "keyswitch2_sharded"),
                   ("parallel.ckks_sharded", "_tail"))
K6_MODES = ("div_round", "div_exact_t")


DIV_ROUND_RUNS = {}   # path -> its K6 launches and ÷P sites (div_round_sites)


def on_card(arg) -> bool:
    """Whether an argument (a tensor, or a context with a device) is on the card."""
    return getattr(getattr(arg, "device", None), "type", None) == "cuda"


@contextlib.contextmanager
def div_round_sites(what):
    """Counts the calls of the DIV_ROUND_SITES functions on the card during the
    block, and raises unless K6 launched exactly once for each: every ÷P of the
    path ran as one K6 launch, none as the plain stage loop.  The counts go
    into DIV_ROUND_RUNS[what]."""
    import importlib
    from heongpu_tpu_torch import kernels
    counts, saved = {}, []
    for mod_name, attr in DIV_ROUND_SITES:
        mod = importlib.import_module(f"heongpu_tpu_torch.{mod_name}")
        f = getattr(mod, attr)

        def counted(*a, _f=f, _name=attr, **k):
            if any(on_card(v) for v in list(a) + list(k.values())):
                counts[_name] = counts.get(_name, 0) + 1
            return _f(*a, **k)
        saved.append((mod, attr, f))
        setattr(mod, attr, counted)
    start = sum(kernels.launches[k] for k in K6_MODES)
    try:
        yield counts
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)
    k6 = sum(kernels.launches[k] for k in K6_MODES) - start
    print(f"{what}: K6 div_round launched {k6} times for {sum(counts.values())} ÷P sites {counts}")
    DIV_ROUND_RUNS[what] = {"div_round": k6, "sites": counts}
    if k6 != sum(counts.values()):
        raise AssertionError(f"{what}: {k6} K6 launches for the ÷P sites {counts}")


def require_launched(what, launches, names):
    """Raises unless each kernel in `names` launched on the path just run."""
    missing = [k for k in names if not launches[k]]
    if missing:
        raise AssertionError(f"{what} never launched {missing}: {launches}")


def print_profile(what, fn, reps, card, tim, key):
    """The idle share and leading kernels of fn, and the hand-written kernels'
    launches and device time (by kernel function) in one call of it."""
    import torch
    from heongpu_tpu_torch import kernels
    busy, wall, idle, per_kernel = device_idle_share(fn, reps)
    kernels.reset_launches()
    fn()
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    own = own_kernels(per_kernel)
    tim.update({f"{key}_busy_ms": busy, f"{key}_wall_ms": wall, f"{key}_idle_share": idle,
                f"{key}_launches": launches, f"{key}_kernel_ms": own})
    print(f"profile {what} x{reps}: device busy {fmt_ms(busy)} ms, wall {wall:.4f} ms per call "
          f"-> idle share {fmt_ms(idle)}; kernel launches per call {launches} [{card}]")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  device {ms:.4f} ms/call: {name[:100]}")
    print("  hand-written kernels, device ms/call: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(own.items(), key=lambda kv: -kv[1])))


def keyswitch_noise(ctx) -> float:
    """The scale of the error one Method-II keyswitch adds to the worst slot.

    The FastBconv digits are not centred: a digit's coefficients have a mean
    of about (alpha/2)·D, D its group's modulus, so Σ_j d_j·e_j / P holds
    (alpha/2)·(D/P)·(1 ⋆ e_j), a signed running sum of the key's gaussian
    error e_j.  That is a low-frequency error: evaluated at the slot root
    nearest X = 1 it is about (2N/π)·σ·sqrt(N).  So one keyswitch adds about
    sqrt(d)·(alpha/2)·(D/P)·(2N/π)·σ·sqrt(N)/scale to the worst slot: it grows
    as N^1.5 and falls with more special primes (p_count > alpha).  Method I
    is the case alpha = 1: d = k digits, each of one prime."""
    groups = ctx.ks2[0].groups if ctx.ks2 else tuple((i,) for i in range(ctx.k))  # Method I
    d_max = max(np.prod([float(ctx.q_primes[i]) for i in g]) for g in groups)
    p_prod = float(np.prod([float(p) for p in ctx.p_primes]))
    alpha = max(len(g) for g in groups)
    n = ctx.n
    return (len(groups) ** 0.5 * alpha / 2 * d_max / p_prod * 2 * n / np.pi
            * GAUSS_SIGMA * n ** 0.5 / ctx.default_scale)


def fused_inputs(ctx, level, gen):
    """Random K5 inputs at a CKKS context's level: (z, mat, k0, k1, tables,
    groups), the arguments of keyswitch2_fused_cuda."""
    from heongpu_tpu_torch.ops import keyswitch_fused as ksf
    lvl, tb, ka = ctx.ks2[level], ctx.ntt_qp_at(level), ctx.active(level)
    d, kqp = len(lvl.groups), tb.num_limbs
    z = rand_residues(ctx.q_primes[:ka], (ka, ctx.n), gen, ctx.device)
    k0, k1 = (rand_residues(list(tb.primes) * d, (d * kqp, ctx.n), gen, ctx.device)
              .view(d, kqp, ctx.n) for _ in range(2))
    return z, ksf.build_fused_mat(lvl, kqp), k0, k1, tb, lvl.groups


def staged_route(ctx, level, args):
    """K5's function by the staged route on K5's arguments at a CKKS level:
    K2 base_conv per digit, K1 forward, K2 mac_keys, K1 inverse."""
    import torch
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.ops import rns
    z, _, k0, k1, tb, groups = args
    digits = torch.stack([rns.base_conv_cuda(z[g[0]: g[-1] + 1], cv.mat_mont, cv.obase)
                          for cv, g in zip(ctx.ks2[level].convs, groups)])
    acc = rns.mac_keys_cuda(nttm.ntt_cuda(digits, tb, False), k0, k1, ctx.base_qp_at(level))
    return nttm.ntt_cuda(acc, tb, True)


def time_kernels(shapes, where, n, card, errs):
    """{label: its record} for shapes {label: (kernel fn, plain fn, shape
    text, (bound ms, bound_by))}, each label's first word the kernel's name:
    each held against its plain version (the worst error into errs), then
    timed (CUDA events, and the device ms of the hand-written kernels from
    torch.profiler, corrected by traced_device_ms for launches the trace
    dropped) beside the plain version and the bound."""
    reps, out = 5, {}
    for name, (kf, pf, what, bnd) in shapes.items():
        got, per_call = kernels_per_call(kf)
        e = max_err(got, pf())
        kernel = name.split()[0]
        errs[kernel] = max(errs[kernel], e)
        if e:
            raise AssertionError(f"{name} disagrees with its plain version at {what}")
        ms_k = cuda_ms(kf, reps=10)
        ms_p = cuda_ms(pf, reps=2, warm=1)
        dev_ms, _, traced, made = traced_device_ms(kf, reps, per_call)
        dropped = dropped_note(traced, made)
        out[name] = {"shape": what, "ms": ms_k, "device_ms": dev_ms, "plain_ms": ms_p,
                     "bound_ms": bnd[0], "bound_by": bnd[1], "launches_traced": traced}
        share = "not measured" if not dev_ms else f"{bnd[0] / dev_ms:.1%}"
        print(f"time {name} at {where} {what} (N={n}): kernel {ms_k:.4f} ms, device "
              f"{fmt_ms(dev_ms)} ms{dropped}, plain {ms_p:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), {share} of the bound on the device [{card}]")
    return out


def keyswitch_bound(args):
    """K5's bound on its arguments: each input and the output once; the row
    transforms of the d digits and the two halves, the digit build (one
    product a term, one fold a digit) and the MAC (one product a digit and
    half, one fold a half), over every limb."""
    z, mat, k0, k1, tb, groups = args
    ka, n = z.shape
    d, kqp = len(groups), tb.num_limbs
    tabs = (tb.p, tb.pinv, tb.mu, tb.tw_mat, tb.tw_mat_sh, tb.itw_mat, tb.itw_mat_sh, tb.tw1p,
            tb.tw1p_sh, tb.tw2p, tb.tw2p_sh, tb.itw1p, tb.itw1p_sh, tb.itw2p, tb.itw2p_sh)
    return bound(nbytes(z, mat, k0, k1, *tabs) + 2 * kqp * n * 4,
                 transform_ops(d * kqp + 2 * kqp, n) + kqp * n * (ka * MAC_OPS + d * FOLD_OPS)
                 + 2 * d * kqp * n * MAC_OPS + 2 * kqp * n * FOLD_OPS)


def base_conv_bound(z, conv, scaled: bool):
    """base_conv's bound on z (B, k_in, N): z, the matrix, the constants and
    the output once; a product per input word and output limb, a fold per
    output word, a Shoup product per input word where the scaling is fused."""
    k_in, k_out = conv.mat_mont.shape
    n = z.shape[-1]
    b = z.numel() // (k_in * n)
    ob = conv.obase
    return bound(nbytes(z, conv.mat_mont, ob.p, ob.pinv, ob.mu, *([conv.scale] if scaled else []))
                 + b * k_out * n * 4,
                 b * n * (k_in * k_out * MAC_OPS + k_out * FOLD_OPS + scaled * k_in * SHOUP_OPS))


def div_round_bound(x, chain):
    """K6's bound on x (B, k+p, N): x, the table and the output once; each
    stage's update of each Q word and of the special words still present."""
    p, k, n = len(chain), chain.k, x.shape[-1]
    b = x.numel() // ((k + p) * n)
    return bound(nbytes(x, chain.tab) + b * k * n * 4,
                 b * n * (k * p + p * (p - 1) // 2) * DIV_OPS)


def conv_shapes(conv, z):
    """time_kernels entries for base_conv on z: unscaled and with the scaling
    fused."""
    from heongpu_tpu_torch.ops import rns
    k_in, k_out = conv.mat_mont.shape
    shape = f"{'x'.join(map(str, z.shape[:-2])) or '1'} x {k_in} -> {k_out}"
    return {
        f"base_conv {k_in}->{k_out} B={z.numel() // (k_in * z.shape[-1])}": (
            lambda: rns.base_conv_cuda(z, conv.mat_mont, conv.obase),
            lambda: rns.base_conv_plain(z, conv.mat_mont, conv.obase),
            shape, base_conv_bound(z, conv, False)),
        f"base_conv {k_in}->{k_out} B={z.numel() // (k_in * z.shape[-1])} scaled": (
            lambda: rns.base_conv_cuda(z, conv.mat_mont, conv.obase, conv.scale),
            lambda: rns.base_conv_plain(z, conv.mat_mont, conv.obase, conv.scale),
            shape + ", scaling fused", base_conv_bound(z, conv, True))}


def div_shapes(chain, x, label):
    """A time_kernels entry for K6 on x."""
    from heongpu_tpu_torch.ops import rns
    p, k = len(chain), chain.k
    return {f"div_round {label}": (
        lambda: rns.div_round_cuda(x, chain), lambda: rns.div_round_chain_plain(x, chain),
        f"{tuple(x.shape)} -> {tuple(x.shape[:-2]) + (k, x.shape[-1])}, p={p}",
        div_round_bound(x, chain))}


def rotation_phase(ctx, cctx, sk, pk, card, errs):
    """Phase 6: the CKKS rotation path on the main-path context.  Returns
    (launch counts of the path, its record, a function that times it)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks, ringkit
    from heongpu_tpu_torch.ops import polyops
    from heongpu_tpu_torch.utils import rng

    n = ctx.n
    log_slots = n.bit_length() - 2
    z = np.random.default_rng(3).uniform(0, 1, n // 2)
    elt = lambda step: polyops.steps_to_galois_elt(step, n)
    ks_noise = keyswitch_noise(ctx)
    dec_errs = {}   # name -> (max abs decode error, keyswitches the result went through)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with held_against_plain("CKKS rotation path", errs), div_round_sites("CKKS rotation path"):
        g = rng.new_generator(2, ctx.device)
        gk = ckks.keygen_galois(ctx, g, sk, steps=[1 << j for j in range(log_slots)])
        ct = ckks.encrypt(ctx, pk, ckks.encode(ctx, z), g)
        err = lambda c, want, k, s=sk: (
            float(np.abs(ckks.decode(ctx, ckks.decrypt(ctx, s, c)) - want).max()), k)
        for step in (1, 3, -1):
            # the chain walk applies one power-of-two key per set bit of the step
            dec_errs[f"rotate_{step}"] = err(ckks.rotate(ctx, ct, gk, step), np.roll(z, -step),
                                             bin(step % (n // 2)).count("1"))
        dec_errs["conjugate"] = err(ckks.conjugate(ctx, ct, gk), np.conj(z), 1)

        def rotate_and_sum():
            acc = ct
            for j in range(log_slots):
                acc = ckks.add(ctx, acc, ckks.rotate(ctx, acc, gk, 1 << j))
            return acc

        sum_err = err(rotate_and_sum(), z.sum(), log_slots)[0]
        d = ckks.hoist(ctx, ct)
        for step in (1, 2, 4, 8):
            dec_errs[f"rotate_hoisted_{step}"] = err(
                ckks.rotate_hoisted(ctx, ct, d, gk.keys[elt(step)]), np.roll(z, -step), 1)
        gki = ckks.keygen_galois(ctx, g, sk, steps=[1, 3], inv_form=True)
        # rotate walks power-of-two steps only: 3 = three applications of the step-1 key
        dec_errs["inv_form_rotate_3"] = err(ckks.rotate(ctx, ct, gki, 3), np.roll(z, -3), 3)
        dec_errs["inv_form_rotate_hoisted_1"] = err(
            ckks.rotate_hoisted(ctx, ct, d, gki.keys[elt(1)]), np.roll(z, -1), 1)
        sk2 = ckks.keygen_secret(ctx, g)
        swk = ckks.keygen_switch(ctx, g, sk, sk2)
        dec_errs["switch_key"] = err(ckks.switch_key(ctx, ct, swk), z, 1, sk2)
        dec_errs["power_of_x"] = err(ckks.multiply_power_of_x(ctx, ct, n // 2), 1j * z, 0)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        print(f"rotation path: {time.perf_counter() - t0:.1f} s, launches {launches}")
    limit = lambda k: TOL_DECODE + 4 * k ** 0.5 * ks_noise
    print(f"rotation path decode errors (limit {TOL_DECODE} + 4 sqrt(keyswitches) x "
          f"{ks_noise:.3e}): " + ", ".join(f"{name} {e:.3e} (k={k}, limit {limit(k):.3e})"
                                           for name, (e, k) in dec_errs.items())
          + f"; rotate-and-sum over {n // 2} slots vs {z.sum():.3f}: {sum_err:.4f} "
            f"(limit {TOL_SUM})")
    require_launched("rotation path", launches,
                     ("ntt_fwd", "ntt_inv", "keyswitch2_fused", "mac_keys", "base_conv"))
    if not (all(e <= limit(k) for e, k in dec_errs.values()) and sum_err <= TOL_SUM):
        raise AssertionError("a rotation decodes above its limit")

    # one rotate (K5) and one rotate_hoisted (K1, K2) on the CPU plain path,
    # on copies of the same key and ciphertext
    t0 = time.perf_counter()
    one = gk.keys[elt(1)]
    cone = key_to(one, "cpu")
    cct = ckks.Ciphertext(ct.c.cpu(), ct.size, ct.level, ct.scale)
    same = (torch.equal(ckks.rotate(ctx, ct, gk, 1).c.cpu(),
                        ckks.rotate(cctx, cct, ringkit.GaloisKey({one.galois_elt: cone}), 1).c)
            and torch.equal(ckks.rotate_hoisted(ctx, ct, d, one).c.cpu(),
                            ckks.rotate_hoisted(cctx, cct, ckks.hoist(cctx, cct), cone).c))
    print(f"rotate and rotate_hoisted by 1 on the CPU plain path identical to the card's: "
          f"{same} ({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("CPU and card rotation residues differ")
    record = {"decode_max_abs_err": {name: e for name, (e, _) in dec_errs.items()},
              "keyswitch_noise": ks_noise, "rotate_and_sum_max_abs_err": sum_err,
              "galois_keys": len(gk.keys), "galois_key_mb": 2 * nbytes(one.k0) / 1e6}

    def timings():
        tim = {"rotate_1_ms": cuda_ms(lambda: ckks.rotate(ctx, ct, gk, 1), reps=10)}

        def hoisted4():
            dd = ckks.hoist(ctx, ct)
            return [ckks.rotate_hoisted(ctx, ct, dd, gk.keys[elt(s)]) for s in (1, 2, 4, 8)]

        tim["rotate_hoisted_ms"] = cuda_ms(hoisted4, reps=5) / 4
        tim["rotate_and_sum_ms"] = cuda_ms(rotate_and_sum, reps=2, warm=1)
        print(f"time rotate by 1: {tim['rotate_1_ms']:.4f} ms; rotate_hoisted (hoist + 4 "
              f"rotations, per rotation): {tim['rotate_hoisted_ms']:.4f} ms; rotate-and-sum "
              f"({log_slots} rotations and adds): {tim['rotate_and_sum_ms']:.4f} ms [{card}]")
        print_profile("CKKS rotate by 1", lambda: ckks.rotate(ctx, ct, gk, 1), 5, card, tim,
                      "rotate_1")
        return tim

    return launches, record, timings


def tfhe_phases(dev, card, check_ntt, time_ntt, errs):
    """Phases 8-10: the TFHE gate-bootstrapping path at STD128 width.
    Returns (launch counts of its main path, kernel times, kernel bounds,
    TFHE timings, {kernel: its per-SM bound and time per step}, K1's timing
    records on the TFHE table)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import tfhe, tfhe_int
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.ops import tfhe_kernel as tk
    from heongpu_tpu_torch.utils import rng

    # -- 8. K1 on the TFHE table, context and keys, K3/K4 against plain ------
    t0 = time.perf_counter()
    ctx = tfhe.make_context(device=dev)
    check_ntt(ctx.ntt, 8, "TFHE 2-limb table")
    check_ntt(ctx.ntt, 8 * TFHE_B, f"TFHE 2-limb table, the accumulators of a {2 * TFHE_B}-gate MUX")
    g = rng.new_generator(11, dev)
    with held_against_plain("TFHE keygen", errs), div_round_sites("TFHE keygen"):
        sk = tfhe.keygen_secret(g, ctx.n, device=dev)
        bk = tfhe.keygen_boot(ctx, g, sk)
        bk2 = tfhe.keygen_boot_unrolled(ctx, g, sk)
        torch.cuda.synchronize()
    print(f"TFHE context and keys: n={ctx.n} N={ctx.N} l={ctx.l} bg_bit={ctx.bg_bit} "
          f"ks base 2^{ctx.ks_base_bit} x{ctx.ks_length}, primes {ctx.primes}, "
          f"bk {tuple(bk.bk.shape)}, bk2 {tuple(bk2.bk2.shape)}, "
          f"{time.perf_counter() - t0:.1f} s")

    r = np.random.default_rng(5)
    chains = {"blind_rotate": (bk.bk, tfhe.blind_rotate_plain, False),
              "blind_rotate2": (bk2.bk2, tfhe.blind_rotate2_plain, True)}
    prologue = {B: tfhe._boot_prologue(ctx, tfhe.encrypt(ctx, sk, r.integers(0, 2, B), g))
                for B in (8, TFHE_B)}
    for name, (key, plain, unrolled) in chains.items():
        acc, a_t = prologue[8]
        e = max_err(tk.blind_rotate_cuda(acc, a_t, key, ctx, unrolled), plain(acc, a_t, key, ctx))
        torch.cuda.synchronize()
        errs[name] = max(errs[name], e)
        print(f"K{4 if unrolled else 3} {name} (B=8, n={ctx.n}): err={e}")
        if e:
            raise AssertionError(f"{name} kernel disagrees with the plain chain")

    # -- 9. the TFHE main path ---------------------------------------------------
    x, y, s = (r.integers(0, 2, TFHE_B).astype(bool) for _ in range(3))
    xs, ys = r.integers(0, 256, HUINT_COUNT), r.integers(0, 256, HUINT_COUNT)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with held_against_plain("TFHE main path", errs), div_round_sites("TFHE main path"):
        cx, cy, cs = (tfhe.encrypt(ctx, sk, v, g) for v in (x, y, s))
        hx = tfhe_int.encrypt_huint(ctx, sk, xs, 8, g)
        hy = tfhe_int.encrypt_huint(ctx, sk, ys, 8, g)
        wrong = []
        for kname, key in (("BootKey", bk), ("BootKey2", bk2)):
            outs = {gate: getattr(tfhe, gate)(ctx, key, cx, cy) for gate in GATES}
            outs["MUX"] = tfhe.MUX(ctx, key, cs, cx, cy)
            outs["NOT"] = tfhe.NOT(ctx, cx)
            want = {gate: fn(x, y) for gate, fn in GATES.items()}
            want.update(MUX=np.where(s, x, y), NOT=~x)
            for gate, ct in outs.items():
                if not (ct.a.shape == (TFHE_B, ctx.n) and
                        np.array_equal(tfhe.decrypt(ctx, sk, ct), want[gate])):
                    wrong.append(f"{gate}/{kname}")
            hs, carry = tfhe_int.add(ctx, key, hx, hy)
            hd, noborrow = tfhe_int.sub(ctx, key, hx, hy)
            dec = lambda h: tfhe_int.decrypt_huint(ctx, sk, h).astype(np.int64)
            bit = lambda c: tfhe.decrypt(ctx, sk, c).astype(np.int64)
            if not (np.array_equal(dec(hs), (xs + ys) % 256) and
                    np.array_equal(bit(carry), (xs + ys) >> 8)):
                wrong.append(f"huint8 add/{kname}")
            if not (np.array_equal(dec(hd), (xs - ys) % 256) and
                    np.array_equal(bit(noborrow), (xs >= ys).astype(np.int64))):
                wrong.append(f"huint8 sub/{kname}")
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        print(f"TFHE main path (B={TFHE_B} gates x 6 + NOT + MUX, huint8 add and sub of "
              f"{HUINT_COUNT}, both key kinds): {time.perf_counter() - t0:.1f} s, "
              f"launches {launches}, wrong: {wrong or 'none'}")
    if wrong:
        raise AssertionError(f"TFHE outputs decrypt wrong: {wrong}")
    require_launched("TFHE main path", launches,
                     ("ntt_fwd", "ntt_inv", "blind_rotate", "blind_rotate2"))

    # the same bootstrap on the CPU plain path, on copies of keys and input
    t0 = time.perf_counter()
    cctx = tfhe.make_context(device="cpu")
    ct2 = tfhe.encrypt(ctx, sk, np.array([1, 0]), g)
    cpu_ct = tfhe.Ciphertext(ct2.a.cpu(), ct2.b.cpu(), ct2.variance)
    for kname, key, ckey in (
            ("BootKey", bk, tfhe.BootKey(bk.bk.cpu(), bk.ksk_a.cpu(), bk.ksk_b.cpu())),
            ("BootKey2", bk2, tfhe.BootKey2(bk2.bk2.cpu(), bk2.ksk_a.cpu(), bk2.ksk_b.cpu()))):
        card_out = tfhe.bootstrap(ctx, key, ct2)
        cpu_out = tfhe.bootstrap(cctx, ckey, cpu_ct)
        same = (torch.equal(card_out.a.cpu(), cpu_out.a) and torch.equal(card_out.b.cpu(), cpu_out.b)
                and card_out.variance == cpu_out.variance)
        print(f"TFHE bootstrap (B=2, n={cctx.n}, {kname}) on the CPU plain path identical "
              f"to the card's: {same} ({time.perf_counter() - t0:.1f} s so far)")
        if not same:
            raise AssertionError("CPU and card TFHE outputs differ")

    # -- 10. timings --------------------------------------------------------------
    def plain_nand(key, c1, c2):
        """NAND with the plain chain in place of K3, on the card."""
        acc, a_t = tfhe._boot_prologue(ctx, tfhe._lin(c1, c2, -1, -1, tfhe.MU, 1))
        acc = tfhe.blind_rotate_plain(acc, a_t, key.bk, ctx)
        return tfhe._boot_epilogue(ctx, key, tfhe._rns_to_torus(ctx, nttm.ntt_inv(acc, ctx.ntt)))

    c8x = tfhe.Ciphertext(cx.a[:8], cx.b[:8], cx.variance)
    c8y = tfhe.Ciphertext(cy.a[:8], cy.b[:8], cy.variance)
    if not torch.equal(plain_nand(bk, c8x, c8y).a, tfhe.NAND(ctx, bk, c8x, c8y).a):
        raise AssertionError("the plain-chain NAND differs from the kernel path")
    tim = {}
    for B, (a1, a2) in ((8, (c8x, c8y)), (TFHE_B, (cx, cy))):
        ms = cuda_ms(lambda: tfhe.NAND(ctx, bk, a1, a2), reps=10)
        pms = cuda_ms(lambda: plain_nand(bk, a1, a2), reps=1, warm=1)
        tim[f"nand_b{B}_ms"], tim[f"nand_b{B}_plain_ms"] = ms, pms
        print(f"time NAND gate bootstrap B={B}: kernel path {ms:.4f} ms "
              f"({ms * 1e3 / B:.2f} us/gate), plain chain {pms:.4f} ms [{card}]")
    kt, per_step = {}, {}
    for name, (key, plain, unrolled) in chains.items():
        steps = ctx.n // 2 if unrolled else ctx.n
        # one gate's transforms on one SM: the least time of a chain that keeps each
        # gate on one SM, whatever B <= SMS
        sm_ms = bound(0, steps * transform_ops(12, ctx.N) * SMS)[0]
        for B in (8, TFHE_B):
            acc, a_t = prologue[B]
            e = max_err(tk.blind_rotate_cuda(acc, a_t, key, ctx, unrolled),
                        plain(acc, a_t, key, ctx))    # also the plain chain's warm-up
            errs[name] = max(errs[name], e)
            if e:
                raise AssertionError(f"{name} disagrees with the plain chain at B={B}")
            ms = cuda_ms(lambda: tk.blind_rotate_cuda(acc, a_t, key, ctx, unrolled), reps=10)
            pms = cuda_ms(lambda: plain(acc, a_t, key, ctx), reps=1, warm=0)
            kt[(name, B)] = (ms, pms)
            us = ms * 1e3 / steps
            tim[f"{name}_b{B}_ms"], tim[f"{name}_b{B}_plain_ms"] = ms, pms
            tim[f"{name}_b{B}_us_per_step"] = us
            print(f"time {name} (B={B}, n={ctx.n}): kernel {ms:.4f} ms = {us:.3f} us per "
                  f"{'pair ' if unrolled else ''}step ({steps}), plain {pms:.4f} ms, err={e}; "
                  f"per-SM bound {sm_ms:.4f} ms = {sm_ms * 1e3 / steps:.3f} us per "
                  f"{'pair ' if unrolled else ''}step [{card}]")
        per_step[name] = {"per_sm_bound_ms": sm_ms, "us_per_step": kt[(name, 8)][0] * 1e3 / steps,
                          "steps": steps}
    for kname, key in (("BootKey", bk), ("BootKey2", bk2)):
        ms = cuda_ms(lambda: tfhe_int.add(ctx, key, hx, hy), reps=3, warm=1)
        mux = cuda_ms(lambda: tfhe.MUX(ctx, key, cs, cx, cy), reps=5, warm=1)
        tim[f"huint8_add_{kname}_ms"], tim[f"mux_b{TFHE_B}_{kname}_ms"] = ms, mux
        print(f"time huint8 add x{HUINT_COUNT} ({kname}): {ms:.4f} ms; MUX B={TFHE_B} "
              f"({kname}): {mux:.4f} ms [{card}]")
    print_profile("NAND B=8", lambda: tfhe.NAND(ctx, bk, c8x, c8y), 5, card, tim, "nand_b8")
    print_profile(f"NAND B={TFHE_B}", lambda: tfhe.NAND(ctx, bk, cx, cy), 5, card, tim,
                  f"nand_b{TFHE_B}")
    print_profile(f"huint8 add x{HUINT_COUNT} (BootKey)", lambda: tfhe_int.add(ctx, bk, hx, hy),
                  2, card, tim, "huint8_add")
    # bounds at the timed B=8 inputs: each step (pair step for K4) runs 12 row
    # transforms of N=1024 points per gate (INTT of the 4 rows of X^a·acc - acc,
    # forward NTT of the 8 digit rows); the key is read once
    tb = ctx.ntt
    tabs = (ctx.omega_pows, ctx.omega_exps, tb.p, tb.pinv, tb.r1, tb.tw1p, tb.tw1p_sh, tb.tw2p,
            tb.tw2p_sh,
            tb.itw1p, tb.itw1p_sh, tb.itw2p, tb.itw2p_sh, tb.tw_mat, tb.tw_mat_sh,
            tb.itw_mat, tb.itw_mat_sh)
    acc, a_t = prologue[8]
    bounds = {}
    for name, (key, _, unrolled) in chains.items():
        steps = ctx.n // 2 if unrolled else ctx.n
        bounds[name] = bound(nbytes(acc, a_t, key, acc, *tabs),
                             acc.shape[0] * steps * transform_ops(12, ctx.N))
    # K1 at the TFHE path's shape: B=8 gates, 2 polys of the 2-limb table
    ntt_recs = {"ntt_fwd": [time_ntt(ctx.ntt, 16, False)], "ntt_inv": [time_ntt(ctx.ntt, 16, True)]}
    return launches, {name: kt[(name, 8)] for name in chains}, bounds, tim, per_step, ntt_recs


def centered_coeffs_host(ctx, pt) -> np.ndarray:
    """The centered coefficients of pt as float64, by a big-int CRT on the host
    (they may exceed 2^59, the limit of the device compose)."""
    from heongpu_tpu_torch.ops import ntt as nttm
    ka = ctx.active(pt.level)
    res = nttm.ntt_inv(pt.m, ctx.ntt_q(pt.level)).cpu().numpy().view(np.uint32).astype(object)
    primes = [int(q) for q in ctx.q_primes[:ka]]
    Q = 1
    for q in primes:
        Q *= q
    acc = sum(res[i] * ((pow(Q // q, -1, q) * (Q // q)) % Q) for i, q in enumerate(primes)) % Q
    return np.array([float(v - Q) if v >= Q // 2 else float(v) for v in acc])


def key_to(kk, dev):
    """A KSKey or GaloisKeyOne with its tensors on `dev`."""
    import dataclasses
    import torch
    return dataclasses.replace(kk, **{f.name: getattr(kk, f.name).to(dev)
                                      for f in dataclasses.fields(kk)
                                      if isinstance(getattr(kk, f.name), torch.Tensor)})


def boot_keys_to(keys, dev):
    """A BootKeys or BootKeysV2 with every tensor on `dev`."""
    import dataclasses
    from heongpu_tpu_torch.models import ckks_boot, ringkit
    piece = lambda p: ckks_boot.Piece(p.level, p.n1, tuple((g, b, pts.to(dev))
                                                          for g, b, pts in p.giants),
                                      p.pt_scale, p.depth)
    ks = lambda k: None if k is None else key_to(k, dev)
    swk = {f: ks(getattr(keys, f)) for f in ("swk_to_sparse", "swk_to_dense") if hasattr(keys, f)}
    return dataclasses.replace(
        keys, gk=ringkit.GaloisKey({e: key_to(k, dev) for e, k in keys.gk.keys.items()}),
        rk=ks(keys.rk),
        ctos_pieces=[piece(p) for p in keys.ctos_pieces],
        stoc_pieces=[piece(p) for p in keys.stoc_pieces],
        mult_i=tuple(t.to(dev) for t in keys.mult_i),
        mult_neg_i=tuple(t.to(dev) for t in keys.mult_neg_i), **swk)


def expanded_keys(ctx, keys):
    """A BootKeys or BootKeysV2 with each stripped key's uniform half
    regenerated over the key's own QP basis (ringkit.ensure_k1), the same
    keys whole."""
    import dataclasses
    from heongpu_tpu_torch.models import ckks, ringkit
    full = lambda k: None if k is None else dataclasses.replace(
        k, k1=ringkit.ensure_k1(lambda: ckks._key_ring(ctx, k), k))
    swk = {f: full(getattr(keys, f)) for f in ("swk_to_sparse", "swk_to_dense") if hasattr(keys, f)}
    return dataclasses.replace(
        keys, gk=ringkit.GaloisKey({e: full(k) for e, k in keys.gk.keys.items()}),
        rk=full(keys.rk), **swk)


def stripped_without_seed(keys):
    """A key set whose Galois and relin keys are stripped with no a_seed to
    regenerate them from (a misuse: ParameterError)."""
    import dataclasses
    from heongpu_tpu_torch.models import ringkit
    strip = lambda k: dataclasses.replace(k, k1=None, a_seed=None)
    return dataclasses.replace(
        keys, gk=ringkit.GaloisKey({e: strip(k) for e, k in keys.gk.keys.items()}),
        rk=strip(keys.rk))


@contextlib.contextmanager
def stripped_key_draws():
    """Counts the stripped-key uses (ringkit.ensure_k1 on a key with no k1,
    each one K7 launch on the card) that the block makes: yields [count]."""
    from heongpu_tpu_torch.models import ringkit
    uses, ensure = [0], ringkit.ensure_k1

    def counting(ring, kk, rows=None):
        uses[0] += kk.k1 is None
        return ensure(ring, kk, rows)
    ringkit.ensure_k1 = counting
    try:
        yield uses
    finally:
        ringkit.ensure_k1 = ensure


def boot_key_bytes(keys) -> dict:
    """Bytes of the Galois keys, the relin key, the diagonal plaintexts and
    (a v2 key set with sparse-secret switching) the two switch keys."""
    gk = sum(nbytes(k.k0, k.k1) for k in keys.gk.keys.values())
    pts = sum(nbytes(pts) for p in keys.ctos_pieces + keys.stoc_pieces for _, _, pts in p.giants)
    swk = [k for k in (getattr(keys, "swk_to_sparse", None), getattr(keys, "swk_to_dense", None))
           if k is not None]
    return {"galois": gk, "relin": nbytes(keys.rk.k0, keys.rk.k1), "diagonals": pts,
            "switch": sum(nbytes(k.k0, k.k1) for k in swk)}


def boot_setup(n, q_bits, ctx_kw, cfg_kw, hw, seed, dev, key_dev=None, compress=False,
               limb_align=1):
    """Context, keys and a ciphertext of z ~ U(-0.5, 0.5) at the last
    base_count limbs.  Keys are made on key_dev (default: dev) from a seeded
    torch.Generator there; compress=True makes the compressed key set, and
    limb_align aligns the keys' limb extents for a limb mesh of that size."""
    import torch
    from heongpu_tpu_torch.models import ckks, ckks_boot
    from heongpu_tpu_torch.utils import rng
    key_dev = key_dev or dev
    ctx = ckks.make_context(n, q_bits, device=key_dev, **ctx_kw)
    g = rng.new_generator(seed, key_dev)
    sk = ckks.keygen_secret(ctx, g, hamming_weight=hw)
    pk = ckks.keygen_public(ctx, g, sk)
    cfg = ckks_boot.BootConfig(**cfg_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keys = ckks_boot.generate_bootstrap_keys(ctx, g, sk, cfg, compress_keys=compress,
                                             limb_align=limb_align)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    z = np.random.default_rng(seed).uniform(-0.5, 0.5, n // 2)
    ct = ckks.encrypt(ctx, pk, ckks.encode(ctx, z, scale=keys.msg_scale), g)
    ct = ckks.mod_drop(ctx, ct, ctx.k - cfg.base_count - ct.level)
    return ctx, sk, keys, ct, z, keygen_s


def boot_error(ctx, sk, out, z):
    from heongpu_tpu_torch.models import ckks
    got = ckks.decode(ctx, ckks.decrypt(ctx, sk, out))
    if not np.isfinite(got).all() or got.shape != z.shape:
        raise AssertionError("bootstrap output decodes to non-finite values or the wrong shape")
    err = np.abs(got.real - z)
    return float(err.max()), float(np.percentile(err, 99))


def boot_phase_errors(ctx, sk, keys, ct):
    """Decrypt between the phases (as benchmarks/benchmark_boot.py --debug
    does): the CtoS output against c_in times the raised coefficients, and
    EvalMod's against v = 2i·sin(2^r θ) (v − v^3/24 with the arcsine term).  Returns the largest overflow |I| of the
    mod-raise (in units of q0), the largest θ and each phase's max abs
    error."""
    import math
    from heongpu_tpu_torch.models import ckks, ckks_boot
    cfg = keys.cfg
    q0 = 1
    for qj in ctx.q_primes[:cfg.base_count]:
        q0 *= int(qj)
    raised = ckks_boot.mod_raise(ctx, ct, cfg.base_count)
    pt = ckks.decrypt(ctx, sk, raised)
    coeffs = centered_coeffs_host(ctx, pt)
    t0, _ = ckks_boot.coeff_to_slot(ctx, raised, keys)
    c_in = 2 * math.pi * keys.msg_scale / ((1 << cfg.exp_squarings) * q0)
    # slot j of t0 holds the low coefficient at the bit-reversal of j (the
    # factored DFT skips the permutation; it cancels in slot_to_coeff)
    half = ctx.n // 2
    bits = half.bit_length() - 1
    br = [int(format(j, f"0{bits}b")[::-1], 2) for j in range(half)]
    want0 = c_in * coeffs[:half][br] / keys.msg_scale
    g0 = ckks.decode(ctx, ckks.decrypt(ctx, sk, t0))
    s0 = ckks_boot.eval_exp_sin(ctx, t0, keys)
    gs = ckks.decode(ctx, ckks.decrypt(ctx, sk, s0))
    v = 2j * np.sin((1 << cfg.exp_squarings) * want0)
    want_s = v - v ** 3 / 24 if cfg.arcsin_order else v
    return {"mod_raise_I_max": float(np.abs(coeffs).max() / q0),
            "ctos_t0": float(np.abs(g0.real - want0).max()),
            "theta_max": float(np.abs(want0).max()),
            "eval_exp_sin_s0": float(np.abs(gs - want_s).max())}


def time_bootstrap(ctx, keys, ct, reps: int = 3):
    """Median ms of one regular_bootstrap and of each of its phases over
    `reps` runs after a warm-up, CUDA events at the phase boundaries."""
    import torch
    from heongpu_tpu_torch.models import ckks_boot
    names = ("mod_raise", "coeff_to_slot", "eval_exp_sin_t0", "eval_exp_sin_t1", "slot_to_coeff")
    ckks_boot.regular_bootstrap(ctx, ct, keys)
    runs = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        raised = ckks_boot.mod_raise(ctx, ct, keys.cfg.base_count)
        ev[1].record()
        t0, t1 = ckks_boot.coeff_to_slot(ctx, raised, keys)
        ev[2].record()
        s0 = ckks_boot.eval_exp_sin(ctx, t0, keys)
        ev[3].record()
        s1 = ckks_boot.eval_exp_sin(ctx, t1, keys)
        ev[4].record()
        ckks_boot.slot_to_coeff(ctx, s0, s1, keys)
        ev[5].record()
        torch.cuda.synchronize()
        runs.append([ev[0].elapsed_time(ev[-1])] + [a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    med = np.median(np.array(runs), axis=0)
    return float(med[0]), dict(zip(names, map(float, med[1:]))), [r[0] for r in runs]


# The scheme-level steps of a bootstrap whose plain passes' device time
# pass_profile reads: (module name, function).
BOOT_PASSES = (("ckks_boot", "mod_raise"), ("ckks_boot", "matvec_piece"), ("ckks", "hoist"),
               ("ckks", "p_scale_to_qtilde"), ("ckks", "rotate_hoisted_qtilde"),
               ("ckks", "ks_finish_at"), ("ckks_boot", "rotate_exact"), ("ckks", "multiply"),
               ("ckks", "relinearize"), ("ckks", "rescale"), ("ckks", "conjugate"),
               ("ckks", "multiply_plain"), ("ckks", "_mul_plain_core"),
               ("ckks", "multiply_by_monomial"), ("ckks", "encode_const"), ("ckks", "add"),
               ("ckks", "sub"), ("ckks", "add_plain"), ("ckks", "sub_plain"), ("ckks", "negate"),
               ("ckks", "switch_key"), ("ckks", "mod_drop"), ("poly_eval", "eval_poly_bsgs"),
               ("poly_eval", "_leaf_block"), ("ckks_boot_ext", "eval_cos_engine"),
               ("ckks_boot_ext", "regular_bootstrap_v2"), ("ckks_boot_ext", "slim_bootstrap"),
               ("ckks_boot_ext", "bit_bootstrap"), ("ckks_boot_ext", "gate_bootstrap"))


def pass_profile(fn) -> dict:
    """{step: device ms} of the plain torch passes in one call of fn (after a
    warm-up), from a torch.profiler trace with a record_function range around
    each function of BOOT_PASSES: each kernel's duration goes to the innermost
    range whose host op launched it, so no kernel counts twice; kernels
    launched outside every range go to "other".  The hand-written kernels,
    launched through ctypes, have no host op in the trace and are left out
    (own_kernels gives their time).  Empty when the trace holds no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from heongpu_tpu_torch.models import ckks, ckks_boot, ckks_boot_ext, poly_eval
    mods = {"ckks": ckks, "ckks_boot": ckks_boot, "ckks_boot_ext": ckks_boot_ext,
            "poly_eval": poly_eval}
    saved = []
    for mod_name, attr in BOOT_PASSES:
        mod = mods[mod_name]
        f = getattr(mod, attr)

        def ranged(*a, _f=f, _label=f"pass:{attr}", **k):
            with record_function(_label):
                return _f(*a, **k)
        saved.append((mod, attr, f))
        setattr(mod, attr, ranged)
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)
    out = {}
    for e in prof.events():
        kern = getattr(e, "kernels", None)
        if not kern:
            continue
        p = e
        while p is not None and not p.name.startswith("pass:"):
            p = p.cpu_parent
        label = p.name[5:] if p is not None else "other"
        out[label] = out.get(label, 0.0) + sum(k.duration for k in kern) / 1e3
    return out


def bootstrap_phases(dev, card, errs, gen, n_mid=1 << 13, n_full=1 << 16):
    """Phases 11-13: CKKS regular bootstrapping.  (a) N=256 precision
    configuration, keys built on the CPU and moved to the card: the card's
    residues must equal the CPU's, error < TOL_BOOT_PRECISE; (b) depth 48 at
    n_mid, keys on the card, error < TOL_BOOT_PRECISE; (c) the same at n_full
    (the main path), every kernel launch at a new shape held against plain,
    error < TOL_BOOT_PRECISE, timings, the profile and the kernels at the new
    shapes.  Returns (launch counts of one bootstrap at n_full, record)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks, ckks_boot
    from heongpu_tpu_torch.ops import keyswitch_fused as ksf
    from heongpu_tpu_torch.ops import rns
    rec = {}

    # -- 11. (a) card against CPU at N=256 -----------------------------------
    t0 = time.perf_counter()
    cctx, csk, ckeys, cct, z, _ = boot_setup(256, PREC_Q_BITS, PREC_CTX, PREC_CFG, 16, 21,
                                             dev, key_dev="cpu")
    cpu_out = ckks_boot.regular_bootstrap(cctx, cct, ckeys)
    dctx = ckks.make_context(256, PREC_Q_BITS, device=dev, **PREC_CTX)
    with held_against_plain("bootstrap N=256", errs), div_round_sites("bootstrap N=256"):
        out = ckks_boot.regular_bootstrap(
            dctx, ckks.Ciphertext(cct.c.to(dev), cct.size, cct.level, cct.scale),
            boot_keys_to(ckeys, dev))
        torch.cuda.synchronize()
    same = torch.equal(out.c.cpu(), cpu_out.c) and out.level == cpu_out.level
    err_a, p99_a = boot_error(cctx, csk, cpu_out, z)
    print(f"bootstrap (a) N=256, {len(PREC_Q_BITS)} primes, {PREC_CFG}: card residues identical "
          f"to the CPU plain path's: {same}; max error {err_a:.3e} (limit {TOL_BOOT_PRECISE}), "
          f"p99 {p99_a:.3e}; {time.perf_counter() - t0:.1f} s")
    if not same or not err_a < TOL_BOOT_PRECISE:
        raise AssertionError("bootstrap (a): card and CPU differ, or the error is above the limit")
    rec["n256"] = {"identical_to_cpu": same, "max_abs_err": err_a, "p99_abs_err": p99_a}
    del cctx, csk, ckeys, cct, cpu_out, dctx, out
    # the same on the compressed key set: the stripped keys regenerate on each side
    t0 = time.perf_counter()
    cctx, csk, ckeys, cct, z, _ = boot_setup(256, PREC_Q_BITS, PREC_CTX, PREC_CFG, 16, 21,
                                             dev, key_dev="cpu", compress=True)
    cpu_out = ckks_boot.regular_bootstrap(cctx, cct, ckeys)
    dctx = ckks.make_context(256, PREC_Q_BITS, device=dev, **PREC_CTX)
    k7 = kernels.launches["threefry_uniform"]
    with held_against_plain("compressed bootstrap N=256", errs), \
            div_round_sites("compressed bootstrap N=256"):
        out = ckks_boot.regular_bootstrap(
            dctx, ckks.Ciphertext(cct.c.to(dev), cct.size, cct.level, cct.scale),
            boot_keys_to(ckeys, dev))
        torch.cuda.synchronize()
    k7 = kernels.launches["threefry_uniform"] - k7
    same = torch.equal(out.c.cpu(), cpu_out.c) and out.level == cpu_out.level
    err_z, _ = boot_error(cctx, csk, cpu_out, z)
    print(f"bootstrap (a') N=256 on the compressed key set: card residues identical to the CPU "
          f"plain path's: {same}; {k7} K7 launches for {stripped_key_uses(ckeys)} stripped-key "
          f"uses; max error {err_z:.3e}; {time.perf_counter() - t0:.1f} s")
    if not same or k7 != stripped_key_uses(ckeys) or not err_z < TOL_BOOT_PRECISE:
        raise AssertionError("bootstrap (a'): card and CPU differ, K7 missed a use, or the "
                             "error is above the limit")
    rec["n256_compressed"] = {"identical_to_cpu": same, "max_abs_err": err_z, "k7_launches": k7}
    del cctx, csk, ckeys, cct, cpu_out, dctx, out

    # -- 12. (b) depth 48 at n_mid ----------------------------------------------
    t0 = time.perf_counter()
    ctx, sk, keys, ct, z, keygen_s = boot_setup(n_mid, BOOT_Q_BITS, BOOT_CTX, BOOT_CFG, BOOT_HW,
                                                22, dev)
    with held_against_plain(f"bootstrap N={n_mid}", errs), div_round_sites(f"bootstrap N={n_mid}"):
        out = ckks_boot.regular_bootstrap(ctx, ct, keys)
        torch.cuda.synchronize()
    err_b, p99_b = boot_error(ctx, sk, out, z)
    # the between-phase decryption runs here every time, so that the
    # diagnostic (c) prints when it fails is known to work on the card
    dbg_b = boot_phase_errors(ctx, sk, keys, ct)
    ms_b, _, _ = time_bootstrap(ctx, keys, ct)
    print(f"bootstrap (b) N={n_mid}, depth {len(BOOT_Q_BITS)}, {BOOT_CFG}, hw {BOOT_HW}: max error "
          f"{err_b:.3e} (limit {TOL_BOOT_PRECISE}), p99 {p99_b:.3e}; errors between the phases "
          f"{dbg_b}; keygen {keygen_s:.1f} s; {ms_b:.2f} ms per bootstrap [{card}]; "
          f"{time.perf_counter() - t0:.1f} s")
    if not err_b < TOL_BOOT_PRECISE:
        raise AssertionError(f"bootstrap (b) at N={n_mid}: error above the limit")
    rec[f"n{n_mid}"] = {"max_abs_err": err_b, "p99_abs_err": p99_b, "phase_errors": dbg_b,
                        "ms": ms_b, "keygen_s": keygen_s}
    del ctx, sk, keys, ct, out
    torch.cuda.empty_cache()

    # -- 13. (c) the main path: depth 48 at n_full ----------------------------------
    t0 = time.perf_counter()
    mem0 = torch.cuda.memory_allocated(dev)
    ctx, sk, keys, ct, z, keygen_s = boot_setup(n_full, BOOT_Q_BITS, BOOT_CTX, BOOT_CFG,
                                                BOOT_HW, 23, dev)
    resident = torch.cuda.memory_allocated(dev) - mem0
    kb = boot_key_bytes(keys)
    pieces = [(p.level, p.n1, sum(len(b) for _, b, _ in p.giants), len(p.giants))
              for p in keys.ctos_pieces + keys.stoc_pieces]
    print(f"bootstrap (c) N={n_full}, depth {len(BOOT_Q_BITS)}: keygen {keygen_s:.1f} s; "
          f"{len(keys.gk.keys)} Galois keys {kb['galois'] / 1e9:.3f} GB, relin "
          f"{kb['relin'] / 1e9:.3f} GB, diagonals {kb['diagonals'] / 1e9:.3f} GB; resident "
          f"{resident / 1e9:.3f} GB; pieces (level, n1, diagonals, giants) {pieces}")
    kernels.reset_launches()
    t1 = time.perf_counter()
    with held_against_plain(f"bootstrap N={n_full}", errs), \
            div_round_sites(f"bootstrap N={n_full}"):
        out = ckks_boot.regular_bootstrap(ctx, ct, keys)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
    print(f"bootstrap (c) main path, held against plain: {time.perf_counter() - t1:.1f} s, "
          f"launches per bootstrap {launches}")
    require_launched("bootstrap main path", launches,
                     ("ntt_fwd", "ntt_inv", "keyswitch2_fused", "mac_keys", "base_conv"))
    err_c, p99_c = boot_error(ctx, sk, out, z)
    print(f"bootstrap (c) max error {err_c:.3e} (limit {TOL_BOOT_PRECISE}), p99 {p99_c:.3e}, "
          f"output level {out.level} [{card}]")
    if not err_c < TOL_BOOT_PRECISE:
        print(f"bootstrap (c) errors between the phases: {boot_phase_errors(ctx, sk, keys, ct)}")
        raise AssertionError(f"bootstrap (c) at N={n_full}: error {err_c} above {TOL_BOOT_PRECISE}")
    torch.cuda.reset_peak_memory_stats(dev)
    ms, phase_ms, runs = time_bootstrap(ctx, keys, ct)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"time bootstrap N={n_full}: {ms:.3f} ms (median of {len(runs)}: "
          + ", ".join(f"{r:.3f}" for r in runs) + "); phases "
          + ", ".join(f"{k} {v:.3f}" for k, v in phase_ms.items()) + f" ms; peak memory_allocated "
          f"{peak / 1e9:.3f} GB [{card}]")
    boot_prof = {}
    print_profile(f"bootstrap N={n_full}", lambda: ckks_boot.regular_bootstrap(ctx, ct, keys), 1,
                  card, boot_prof, "bootstrap")
    steps = pass_profile(lambda: ckks_boot.regular_bootstrap(ctx, ct, keys))
    own_ms = sum(boot_prof["bootstrap_kernel_ms"].values())
    print(f"bootstrap N={n_full}, plain passes' device ms by step: " + (", ".join(
        f"{k} {ms:.3f}" for k, ms in sorted(steps.items(), key=lambda kv: -kv[1]))
        or "not measured") + f"; sum {sum(steps.values()):.3f}, hand-written kernels "
        f"{own_ms:.3f}, device busy {fmt_ms(boot_prof['bootstrap_busy_ms'])} [{card}]")

    # the kernels at the bootstrap's new shapes: K5 at level 0 (54 limbs, 12
    # digits), K2 mac_keys over 12 digits x 54 limbs, base_conv 4 -> 54
    shapes = {}
    fargs = fused_inputs(ctx, 0, gen)
    kern = lambda: ksf.keyswitch2_fused_cuda(*fargs)
    e = max_err(kern(), ksf.keyswitch2_fused_core_plain(*fargs))
    errs["keyswitch2_fused"] = max(errs["keyswitch2_fused"], e)
    if e:
        raise AssertionError("K5 disagrees with its plain version at the bootstrap's level 0")
    shapes["keyswitch2_fused"] = (kern, lambda: ksf.keyswitch2_fused_core_plain(*fargs),
                                  f"z {tuple(fargs[0].shape)}, {len(fargs[5])} digits, "
                                  f"{fargs[4].num_limbs} limbs", keyswitch_bound(fargs))
    bq = ctx.base_qp
    qp = list(ctx.qp_primes)
    nd = len(ctx.ks2[0].groups)
    dd, k0, k1 = (rand_residues(qp * nd, (nd * len(qp), n_full), gen, dev).view(nd, len(qp), n_full)
                  for _ in range(3))
    shapes["mac_keys"] = (lambda: rns.mac_keys_cuda(dd, k0, k1, bq),
                          lambda: mac_keys_plain(dd, k0, k1, bq), f"{tuple(dd.shape)}",
                          bound(nbytes(dd, k0, k1, dd[:2], bq.p, bq.pinv, bq.mu),
                                2 * dd.numel() * MAC_OPS + 2 * len(qp) * n_full * FOLD_OPS))
    conv = ctx.ks2[0].convs[0]
    zc = rand_residues([int(v) for v in conv.ibase.p.tolist()], (conv.mat_mont.shape[0], n_full),
                       gen, dev)
    shapes.update(conv_shapes(conv, zc))
    # K6 on a keyswitch's two halves over the 54-limb basis, six special primes
    x54 = rand_residues(qp * 2, (2 * len(qp), n_full), gen, dev).view(2, len(qp), n_full)
    shapes.update(div_shapes(ctx.ks2[0].div_stages, x54, "keyswitch"))
    shapes = time_kernels(shapes, "the bootstrap's", n_full, card, errs)
    rec[f"n{n_full}"] = {
        "max_abs_err": err_c, "p99_abs_err": p99_c, "ms": ms, "runs_ms": runs,
        "phase_ms": phase_ms, "keygen_s": keygen_s, "resident_bytes": resident,
        "key_bytes": kb, "galois_keys": len(keys.gk.keys), "pieces": pieces,
        "launches": launches, "profile": boot_prof, "peak_bytes": peak,
        "plain_device_ms_by_step": steps, "kernels": shapes,
        "seconds": time.perf_counter() - t0}
    rec["out_c"] = out.c   # phase 21 holds the sharded bootstrap against it
    full_bytes = sum(kb.values())
    del keys, out, fargs, dd, k0, k1, zc, x54
    torch.cuda.empty_cache()
    # -- 13. (c') the same bootstrap on the compressed key set -----------------------
    launches_z, rec["compressed"] = compressed_bootstrap(
        ctx, sk, ct, z, ckks_boot.BootConfig(**BOOT_CFG), full_bytes, card, errs)
    del ctx, sk, ct
    torch.cuda.empty_cache()
    return {k: launches[k] + launches_z[k] for k in launches}, rec


def stripped_key_uses(keys) -> int:
    """The keyswitches of one regular_bootstrap, each of which regenerates its
    stripped key's uniform half (one K7 launch): every piece's distinct
    nonzero baby steps (rotate_hoisted_qtilde) and nonzero giant steps
    (rotate_exact), the two conjugations of ctos_finish, and in each of the
    two eval_exp_sin calls its relinearizations (taylor_degree - 1 Horner
    products, exp_squarings squarings, two more with the arcsine term) and
    its conjugation."""
    cfg = keys.cfg
    rot = sum(len({b for _, babies, _ in p.giants for b in babies if b})
              + sum(1 for g, _, _ in p.giants if g)
              for p in keys.ctos_pieces + keys.stoc_pieces)
    relins = cfg.taylor_degree - 1 + cfg.exp_squarings + (2 if cfg.arcsin_order else 0)
    return rot + 2 + 2 * (relins + 1)


def compressed_bootstrap(ctx, sk, ct, z, cfg, full_bytes, card, errs):
    """Phase 13 (c'): the depth-48 bootstrap on the compressed key set
    (generate_bootstrap_keys(compress_keys=True): every Galois and relin key
    stored stripped, its uniform half regenerated by K7 at each use).  Key
    bytes against the full set's, keygen seconds, no two keys sharing a
    Threefry key (a_seed mod 2^32, where the reference's layout collides); one bootstrap with
    launches counted from 0, every launch at a new shape held against plain,
    K7's launches equal to the stripped-key uses counted in ensure_k1 and to
    stripped_key_uses; the error within TOL_BOOT_PRECISE; the median of 3 and
    the device busy time and idle share; one regenerated k1 on the card equal
    to the CPU's plain Threefry; K7 timed at the largest key's shape.  Returns
    (launches of the bootstrap, record)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks, ckks_boot, ringkit
    from heongpu_tpu_torch.utils import rng, threefry
    t0 = time.perf_counter()
    n = ctx.n
    g = rng.new_generator(24, ctx.device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    keys = ckks_boot.generate_bootstrap_keys(ctx, g, sk, cfg, compress_keys=True)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t1
    kb = boot_key_bytes(keys)
    seeded = list(keys.gk.keys.values()) + [keys.rk]
    residues = [k.a_seed % 2 ** 32 for k in seeded]
    sharing = sum(1 for r in residues if residues.count(r) > 1)
    predicted = stripped_key_uses(keys)
    print(f"bootstrap (c') N={n} compressed: keygen {keygen_s:.1f} s; {len(keys.gk.keys)} Galois "
          f"keys {kb['galois'] / 1e9:.3f} GB, relin {kb['relin'] / 1e9:.3f} GB, diagonals "
          f"{kb['diagonals'] / 1e9:.3f} GB: {sum(kb.values()) / 1e9:.3f} GB against the full "
          f"set's {full_bytes / 1e9:.3f} GB; {sharing} of {len(seeded)} keys share their a_seed "
          f"mod 2^32 with another (one Threefry key)")
    if sharing:
        raise AssertionError(f"compressed key set: {sharing} keys share a Threefry key")
    with stripped_key_draws() as uses:
        kernels.reset_launches()
        t1 = time.perf_counter()
        with held_against_plain(f"compressed bootstrap N={n}", errs), \
                div_round_sites(f"compressed bootstrap N={n}"):
            out = ckks_boot.regular_bootstrap(ctx, ct, keys)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
    k7 = launches["threefry_uniform"]
    print(f"bootstrap (c') main path, held against plain: {time.perf_counter() - t1:.1f} s, "
          f"launches {launches}; K7 launched {k7} times for {uses[0]} stripped-key uses "
          f"(predicted {predicted})")
    require_launched("compressed bootstrap", launches,
                     ("ntt_fwd", "ntt_inv", "keyswitch2_fused", "mac_keys", "base_conv",
                      "threefry_uniform"))
    if not k7 == uses[0] == predicted:
        raise AssertionError(f"compressed bootstrap: {k7} K7 launches, {uses[0]} stripped-key "
                             f"uses, {predicted} predicted")
    err, p99 = boot_error(ctx, sk, out, z)
    print(f"bootstrap (c') max error {err:.3e} (limit {TOL_BOOT_PRECISE}), p99 {p99:.3e} [{card}]")
    if not err < TOL_BOOT_PRECISE:
        raise AssertionError(f"compressed bootstrap: error {err} above {TOL_BOOT_PRECISE}")
    ms, phase_ms, runs = time_bootstrap(ctx, keys, ct)
    print(f"time compressed bootstrap N={n}: {ms:.3f} ms (median of {len(runs)}: "
          + ", ".join(f"{r:.3f}" for r in runs) + "); phases "
          + ", ".join(f"{k} {v:.3f}" for k, v in phase_ms.items()) + f" ms [{card}]")
    prof = {}
    print_profile(f"compressed bootstrap N={n}", lambda: ckks_boot.regular_bootstrap(ctx, ct, keys),
                  1, card, prof, "bootstrap")
    # one regenerated k1 (the smallest key's) against the CPU's plain Threefry
    small = min(keys.gk.keys.values(), key=lambda k: k.k0.numel())
    ring = ckks._key_ring(ctx, small)
    on_card = ringkit.ensure_k1(ring, small).cpu()
    on_cpu = threefry.uniform_rns_plain(threefry.key_from_seed(small.a_seed), ring.qp_primes,
                                        (small.k0.shape[0], n), "cpu", True, True)
    same = torch.equal(on_card, on_cpu)
    print(f"bootstrap (c') k1 of the {tuple(small.k0.shape)} key regenerated on the card equal "
          f"to the CPU's plain Threefry: {same}")
    if not same:
        raise AssertionError("compressed bootstrap: K7's k1 differs from the CPU's")
    errs["threefry_uniform"] = max(errs["threefry_uniform"], int((on_card.long() - on_cpu.long())
                                                                 .abs().max()))
    big = max(seeded, key=lambda k: k.k0.numel())
    kern = time_kernels(threefry_shapes(ckks._key_ring(ctx, big).qp_primes,
                                        (big.k0.shape[0], n), ctx.device,
                                        "bootstrap key", seed=big.a_seed),
                        "the compressed bootstrap's", n, card, errs)
    rec = {"keygen_s": keygen_s, "key_bytes": kb, "full_key_bytes": full_bytes,
           "keys_sharing_a_threefry_key": sharing, "keys": len(seeded), "launches": launches,
           "stripped_key_uses": uses[0], "predicted_uses": predicted, "max_abs_err": err,
           "p99_abs_err": p99, "ms": ms, "runs_ms": runs, "phase_ms": phase_ms, "profile": prof,
           "k1_identical_to_cpu": same, "kernels": kern, "seconds": time.perf_counter() - t0}
    del keys, out
    torch.cuda.empty_cache()
    return launches, rec


# The bootstrapping variants (phase 14): the JAX package's v2 chain
# (tests/test_ckks_boot_v2.py: 29-bit q0, eighteen 28-bit scale primes,
# BootConfigV2(24, 5, 12), 2 + 2 pieces, secret hw 16) with Method II, alpha 4
# and six special primes (p_count > alpha for keyswitch headroom at N=2^16).
V2_Q_BITS = [29] + [28] * 18
V2_CTX = dict(scale_bits=28, ks_type="II", alpha=4, p_count=6)
V2_CFG = dict(cos_degree=24, double_angles=5, K=12)
V2_HW = 16
V2_SPARSE_HW = 16       # the sparse run: a dense secret (hw N/2), a temporary key of hw 16
V2_SLIM_SCALE = 2.0 ** 22
# Each run's error limit at N=256, the size the JAX package's tests run the
# variants at: its own limit (tests/test_ckks_boot_v2.py: regular, sparse and
# less-key mode 1e-2, slim 3e-2, bit and gates 0.1), or about 10x the error
# the H100 run measured (2.3e-4 bit, 5.4e-4 gates) where that is lower.
TOL_V2 = {"regular": 1e-2, "sparse": 1e-2, "less_key": 1e-2, "slim": 3e-2, "bit": 3e-3,
          "gate": 6e-3}
# At N=2^16 only bit and gate bootstrapping refresh their message on this
# chain (measured 1.2e-2 .. 1.6e-2; 10x that is above the reference's 0.1,
# which holds).  Regular v2, slim, the sparse switch and less-key mode read
# 1.2, 3.0, 22 and 1.2 there: the EvalMod noise at a 2^28 scale grows as
# sqrt(N·hw), and a full-slot message's coefficients shrink as 1/sqrt(N)
# (PERF.md §6), so no limit of the reference's holds at that N and
# those runs are held to the CPU plain path's residues instead (v2_cpu_checks).
TOL_V2_FULL = {"bit": 0.1, "gate": 0.1}


def v2_tol(name, table):
    """The limit of run `name` in `table` (the gates share "gate"), or None."""
    return table.get("gate" if name in GATES else name)


# The steps of a variant whose CUDA-event time phase_ms reads: (function of
# ckks_boot_ext, phase name).  None calls another; "other" is the rest.
V2_PHASES = (("_apply_stoc", "StoC"), ("_raise_maybe_sparse", "raise"),
             ("_coeff_to_slot", "CtoS"), ("eval_cos_engine", "EvalMod"))


def v2_entry(name, mod):
    """Run `name`'s entry point fn(ctx, *inputs, keys) in `mod`:
    models.ckks_boot_ext, or parallel.boot_ext_sharded, which mirrors its
    names."""
    if name in GATES:
        return lambda c, a, b, k: mod.gate_bootstrap(c, a, b, name, k)
    return getattr(mod, {"slim": "slim_bootstrap", "bit": "bit_bootstrap"}.get(
        name, "regular_bootstrap_v2"))


def v2_runs(ctx, sk, pk, gen, n, sk_dense, pk_dense):
    """{run: (keygen kwargs, fn, inputs, the expected slots, the secret it
    decrypts under)} for every phase-14 run; fn(ctx, *inputs, keys) is the
    entry point (v2_entry), and the inputs are encrypted at the variant's
    msg_scale and dropped to its entry level."""
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.models import ckks_boot_ext as ext
    r = np.random.default_rng(n)
    z = r.uniform(-0.5, 0.5, n // 2)
    bits = r.integers(0, 2, n // 2)
    b1, b2 = r.integers(0, 2, n // 2).astype(bool), r.integers(0, 2, n // 2).astype(bool)
    q0 = int(ctx.q_primes[0])
    last, stoc0 = ctx.k - 1, ctx.k - 1 - 2      # StoC's two pieces end on q0

    def enc(values, scale, level, key=pk):
        pt = ckks.encode(ctx, np.asarray(values, np.float64), scale=scale)
        return ckks.mod_drop(ctx, ckks.encrypt(ctx, key, pt, gen), level)

    ct_z = enc(z, ctx.default_scale, last)
    gates_in = (enc(b1, q0 / 3.0, stoc0), enc(b2, q0 / 3.0, stoc0))
    runs = {
        "regular": ({}, (ct_z,), z, sk),
        "slim": (dict(variant="slim", msg_scale=V2_SLIM_SCALE), (enc(z, V2_SLIM_SCALE, stoc0),),
                 z, sk),
        "bit": (dict(variant="bit"), (enc(bits, q0 / 2.0, stoc0),), bits, sk),
    }
    for gate, fn in GATES.items():
        runs[gate] = (dict(variant="gate"), gates_in, fn(b1, b2).astype(np.float64), sk)
    runs["sparse"] = (dict(sparse_hw=V2_SPARSE_HW), (enc(z, ctx.default_scale, last, pk_dense),),
                      z, sk_dense)
    runs["less_key"] = (dict(less_key_mode=True), (ct_z,), z, sk)
    return {name: (kw, v2_entry(name, ext), *rest) for name, (kw, *rest) in runs.items()}


def v2_phase_errors(ctx, sk, keys, ct):
    """Decrypt between the phases of regular_bootstrap_v2: the mod-raise's
    overflow |I| (in units of q0), the CtoS output t0 against A/(2^r·R)
    (A = 2π·raw/q0 of the raised low coefficients), EvalMod's against
    sin(A), each as a max abs error, and the largest |A| / (2^r·R)."""
    import math
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.models import ckks_boot_ext as ext
    cfg = keys.cfg
    q0 = int(ctx.q_primes[0])
    raised = ext._raise_maybe_sparse(ctx, ct, keys)
    coeffs = centered_coeffs_host(ctx, ckks.decrypt(ctx, sk, raised))
    half = ctx.n // 2
    bits = half.bit_length() - 1
    br = [int(format(j, f"0{bits}b")[::-1], 2) for j in range(half)]
    a = 2 * math.pi * coeffs[:half][br] / q0
    want_t = a / ((1 << cfg.double_angles) * cfg.R)
    t0, _ = ext._coeff_to_slot(ctx, raised, keys)
    s0 = ext.eval_mod_sin(ctx, t0, keys)
    dec = lambda c: ckks.decode(ctx, ckks.decrypt(ctx, sk, c)).real
    return {"mod_raise_I_max": float(np.abs(coeffs).max() / q0),
            "t_max": float(np.abs(want_t).max()),
            "ctos_t0": float(np.abs(dec(t0) - want_t).max()),
            "evalmod_s0": float(np.abs(dec(s0) - np.sin(a)).max())}


def v2_cpu_checks(ctx, n):
    """{run: check(keys, inputs)} holding what each run at n adds to the
    path against the CPU plain path on copies of the same keys and inputs,
    bit for bit: regular v2's EvalMod of t0 (poly_eval, the double angles),
    the sparse run's raise (the two switch keys around mod_raise), and
    less-key mode's largest composed giant rotation of its second CtoS
    piece (ckks.rotate's chain).  Each check raises on a difference and
    returns True."""
    import dataclasses
    import torch
    from heongpu_tpu_torch.models import ckks, ckks_boot, ringkit
    from heongpu_tpu_torch.models import ckks_boot_ext as ext
    from heongpu_tpu_torch.ops import polyops
    cctx = ckks.make_context(n, V2_Q_BITS, device="cpu", **V2_CTX)
    cpu = lambda c: ckks.Ciphertext(c.c.cpu(), c.size, c.level, c.scale)
    ks = lambda k: None if k is None else key_to(k, "cpu")
    bare = lambda keys, **kw: dataclasses.replace(keys, **{   # only what a check reads
        "gk": ringkit.GaloisKey({}), "rk": ks(keys.rk), "ctos_pieces": [], "stoc_pieces": [],
        "mult_i": (), "mult_neg_i": (), "swk_to_sparse": None, "swk_to_dense": None, **kw})

    def held(what, card_out, cpu_out):
        same = torch.equal(card_out.c.cpu(), cpu_out.c) and card_out.level == cpu_out.level
        print(f"  {what} at N={n}: card residues identical to the CPU plain path's: {same}")
        if not same:
            raise AssertionError(f"{what} at N={n}: card and CPU residues differ")
        return True

    def evalmod(keys, inputs):
        t0, _ = ext._coeff_to_slot(ctx, ext._raise_maybe_sparse(ctx, inputs[0], keys), keys)
        return held("regular v2 EvalMod of t0", ext.eval_mod_sin(ctx, t0, keys),
                    ext.eval_mod_sin(cctx, cpu(t0), bare(keys)))

    def sparse_raise(keys, inputs):
        return held("the sparse-switch raise", ext._raise_maybe_sparse(ctx, inputs[0], keys),
                    ext._raise_maybe_sparse(cctx, cpu(inputs[0]), bare(
                        keys, swk_to_sparse=ks(keys.swk_to_sparse),
                        swk_to_dense=ks(keys.swk_to_dense))))

    def composed(keys, inputs):
        piece = keys.ctos_pieces[1]
        step = max(g for g, _, _ in piece.giants
                   if polyops.steps_to_galois_elt(g, n) not in keys.gk.keys)
        c = ckks.mod_drop(ctx, ext._raise_maybe_sparse(ctx, inputs[0], keys), piece.level)
        pow2 = {polyops.steps_to_galois_elt(1 << j, n) for j in range(n.bit_length())}
        gk = ringkit.GaloisKey({e: key_to(k, "cpu") for e, k in keys.gk.keys.items()
                                if e in pow2})
        return held(f"less-key mode's giant rotation by {step} (composed)",
                    ckks_boot.rotate_exact(ctx, c, keys.gk, step),
                    ckks_boot.rotate_exact(cctx, cpu(c), gk, step))

    return {"regular": evalmod, "sparse": sparse_raise, "less_key": composed}


def phase_ms(fn, reps: int = 3):
    """Median ms of one call of fn and of each V2_PHASES step in it over
    `reps` calls after a warm-up: CUDA events around the whole call and
    around each step (the steps do not nest)."""
    import torch
    from heongpu_tpu_torch.models import ckks_boot_ext as ext
    fn()
    runs, saved = [], []
    marks = []
    for attr, name in V2_PHASES:
        f = getattr(ext, attr)

        def timed(*a, _f=f, _name=name, **k):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = _f(*a, **k)
            ev[1].record()
            marks.append((_name, ev))
            return out
        saved.append((attr, f))
        setattr(ext, attr, timed)
    try:
        for _ in range(reps):
            marks.clear()
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize()
            total = ev[0].elapsed_time(ev[1])
            by = {}
            for name, (a, b) in marks:
                by[name] = by.get(name, 0.0) + a.elapsed_time(b)
            by["other"] = total - sum(by.values())
            runs.append((total, by))
    finally:
        for attr, f in saved:
            setattr(ext, attr, f)
    names = sorted({k for _, by in runs for k in by})
    med = {k: float(np.median([by.get(k, 0.0) for _, by in runs])) for k in names}
    return float(np.median([t for t, _ in runs])), med, [t for t, _ in runs]


def bootstrap_v2_phases(dev, card, errs, n_small=256, n_full=1 << 16):
    """Phase 14: the bootstrapping variants.  (a) n_small, keys made on the
    CPU and moved to the card: every run's residues on the card must equal
    the CPU's, its error within TOL_V2; (b) n_full, one key set at a time
    on the card: each run held against plain as it happens, its launches
    counted from 0, its max and p99 error over all slots printed (bit and
    the gates within TOL_V2_FULL), the parts v2_cpu_checks names equal to
    the CPU plain path's; regular, slim, bit, NAND and less-key mode timed
    (median of 3, the ms of each step) with the device busy time and idle
    share, and the regular run's errors between the phases and device time
    by step.  Returns (the launches of every run at n_full, summed; record)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.models import ckks_boot_ext as ext
    from heongpu_tpu_torch.utils import rng
    cfg = ext.BootConfigV2(**V2_CFG)
    rec = {}

    # -- 14. (a) card against CPU at n_small -----------------------------------
    t0 = time.perf_counter()
    cctx = ckks.make_context(n_small, V2_Q_BITS, device="cpu", **V2_CTX)
    dctx = ckks.make_context(n_small, V2_Q_BITS, device=dev, **V2_CTX)
    g = rng.new_generator(31, "cpu")
    sk = ckks.keygen_secret(cctx, g, hamming_weight=V2_HW)
    pk = ckks.keygen_public(cctx, g, sk)
    skd = ckks.keygen_secret(cctx, g)
    runs = v2_runs(cctx, sk, pk, g, n_small, skd, ckks.keygen_public(cctx, g, skd))
    to_dev = lambda c: ckks.Ciphertext(c.c.to(dev), c.size, c.level, c.scale)
    same_all, errs_a, keys_by = {}, {}, {}
    with held_against_plain(f"bootstrap variants N={n_small}", errs), \
            div_round_sites(f"bootstrap variants N={n_small}"):
        for name, (kw, fn, inputs, want, skey) in runs.items():
            if repr(kw) not in keys_by:
                keys_by[repr(kw)] = ext.generate_bootstrap_keys_v2(
                    cctx, g, skd if name == "sparse" else sk, cfg, **kw)
            keys = keys_by[repr(kw)]
            cpu_out = fn(cctx, *inputs, keys)
            out = fn(dctx, *map(to_dev, inputs), boot_keys_to(keys, dev))
            torch.cuda.synchronize()
            same_all[name] = (torch.equal(out.c.cpu(), cpu_out.c) and out.level == cpu_out.level
                              and out.scale == cpu_out.scale)
            errs_a[name] = boot_error(cctx, skey, cpu_out, want)[0]
    print(f"bootstrap variants (a) N={n_small}, {len(V2_Q_BITS)} primes, {V2_CFG}: card residues "
          f"identical to the CPU plain path's: {same_all}; max errors "
          + ", ".join(f"{k} {v:.3e} (limit {v2_tol(k, TOL_V2)})" for k, v in errs_a.items())
          + f"; {time.perf_counter() - t0:.1f} s")
    if not all(same_all.values()):
        raise AssertionError("bootstrap variants (a): card and CPU residues differ")
    over = [k for k, v in errs_a.items() if not v < v2_tol(k, TOL_V2)]
    if over:
        raise AssertionError(f"bootstrap variants (a): error above the limit for {over}")
    rec[f"n{n_small}"] = {"identical_to_cpu": same_all, "max_abs_err": errs_a}
    del cctx, dctx, keys_by, runs

    # -- 14. (b) every run at n_full, one key set at a time ----------------------------
    ctx = ckks.make_context(n_full, V2_Q_BITS, device=dev, **V2_CTX)
    gen = rng.new_generator(41, dev)
    sk = ckks.keygen_secret(ctx, gen, hamming_weight=V2_HW)
    pk = ckks.keygen_public(ctx, gen, sk)
    skd = ckks.keygen_secret(ctx, gen)
    runs = v2_runs(ctx, sk, pk, gen, n_full, skd, ckks.keygen_public(ctx, gen, skd))
    timed = ("regular", "slim", "bit", "NAND", "less_key")
    cpu_checks = v2_cpu_checks(ctx, n_full)
    total = dict.fromkeys(kernels.launches, 0)
    keys, keys_kw = None, None
    # what phase 22 holds the sharded runs against: each run's generator state
    # before its key set was made, its inputs and output
    refs = {"ctx": ctx, "sk": sk, "runs": {}}
    for name, (kw, fn, inputs, want, skey) in runs.items():
        call = lambda k, fn=fn, inputs=inputs: fn(ctx, *inputs, k)
        t0 = time.perf_counter()
        r = {}
        if kw != keys_kw:
            del keys
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated(dev)
            gen_state = gen.get_state()
            t1 = time.perf_counter()
            keys = ext.generate_bootstrap_keys_v2(ctx, gen, skd if name == "sparse" else sk,
                                                  cfg, **kw)
            torch.cuda.synchronize()
            keys_kw = kw
            kb = boot_key_bytes(keys)
            r.update(keygen_s=time.perf_counter() - t1, galois_keys=len(keys.gk.keys),
                     key_bytes=kb, resident_bytes=torch.cuda.memory_allocated(dev) - mem0)
            print(f"bootstrap variant {name} N={n_full}: keygen {r['keygen_s']:.2f} s; "
                  f"{len(keys.gk.keys)} Galois keys {kb['galois'] / 1e9:.3f} GB, relin "
                  f"{kb['relin'] / 1e9:.3f} GB, diagonals {kb['diagonals'] / 1e9:.3f} GB, switch "
                  f"{kb['switch'] / 1e9:.3f} GB; resident {r['resident_bytes'] / 1e9:.3f} GB")
        kernels.reset_launches()
        with held_against_plain(f"bootstrap {name} N={n_full}", errs), \
                div_round_sites(f"bootstrap {name} N={n_full}"):
            out = call(keys)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
        require_launched(f"bootstrap {name}", launches,
                         ("ntt_fwd", "ntt_inv", "keyswitch2_fused", "mac_keys", "base_conv"))
        total = {k: total[k] + launches[k] for k in total}
        if name in V2_SHARDED_KEPT:
            refs["runs"][name] = {"kw": kw, "gen_state": gen_state, "inputs": inputs,
                                  "want": want, "out": out}
        err, p99 = boot_error(ctx, skey, out, want)
        tol = v2_tol(name, TOL_V2_FULL)
        r.update(max_abs_err=err, p99_abs_err=p99, launches=launches, output_level=out.level)
        print(f"bootstrap variant {name} N={n_full}: max error {err:.3e} ("
              + (f"limit {tol}" if tol else f"no limit at N={n_full}: the chain's EvalMod noise, "
                 "PERF.md §6") + f"), p99 {p99:.3e}, output level {out.level}; "
              f"launches {launches} [{card}]")
        if tol and not err < tol:
            raise AssertionError(f"bootstrap variant {name} at N={n_full}: error {err} above {tol}")
        if name in cpu_checks:
            r["identical_to_cpu"] = cpu_checks[name](keys, inputs)
        if name in timed:
            ms, steps, reps = phase_ms(lambda: call(keys))
            prof = {}
            print_profile(f"bootstrap {name} N={n_full}", lambda: call(keys), 1, card, prof, "run")
            r.update(ms=ms, runs_ms=reps, phase_ms=steps, profile=prof)
            print(f"time bootstrap {name} N={n_full}: {ms:.3f} ms (median of {len(reps)}: "
                  + ", ".join(f"{x:.3f}" for x in reps) + "); steps "
                  + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()) + f" ms [{card}]")
        if name == "regular":
            r["phase_errors"] = pe = v2_phase_errors(ctx, sk, keys, inputs[0])
            print(f"bootstrap regular v2 N={n_full}, errors between the phases: {pe}")
            r["plain_device_ms_by_step"] = st = pass_profile(lambda: call(keys))
            print(f"bootstrap regular v2 N={n_full}, plain passes' device ms by step: " + (", ".join(
                f"{k} {v:.3f}" for k, v in sorted(st.items(), key=lambda kv: -kv[1]))
                or "not measured") + f" [{card}]")
        r["seconds"] = time.perf_counter() - t0
        rec.setdefault(f"n{n_full}", {})[name] = r
    del keys
    torch.cuda.empty_cache()
    std, lkm = rec[f"n{n_full}"]["regular"], rec[f"n{n_full}"]["less_key"]
    print(f"less-key mode against the standard set, N={n_full}: {lkm['galois_keys']} Galois keys "
          f"{lkm['key_bytes']['galois'] / 1e9:.3f} GB against {std['galois_keys']} keys "
          f"{std['key_bytes']['galois'] / 1e9:.3f} GB "
          f"({lkm['key_bytes']['galois'] / std['key_bytes']['galois'] - 1:+.1%}); "
          f"{lkm['ms']:.3f} ms against {std['ms']:.3f} ms ({lkm['ms'] / std['ms'] - 1:+.1%}) [{card}]")
    rec["sharded_refs"] = refs   # phase 22 holds the sharded runs against them
    return total, rec


# BFV (phase 15): the entry point's default chain at N=2^15
# (params.default_coeff_modulus at tc128: 29 Q primes of 29 bits and one 30-bit
# special prime, Method I, Bsk of 31 + 1 primes) and the repo's own BFV bench
# shape (benchmarks/benchmark_bfv.py:28-33,72: eight 29-bit Q primes, Method II
# with alpha 2), t = plain_modulus_for(N, 20) on both.
BFV_N = 1 << 15
BFV_T_BITS = 20
BFV_BENCH_Q_BITS = [29] * 8
BFV_BENCH_ALPHA = 2
BFV_SMALL_Q_BITS = [29] * 4     # the N=256 card-against-CPU run, both methods


def median_ms(fn, reps: int = 7, warm: int = 2):
    """Median ms of one call of fn over `reps` calls, CUDA events around each."""
    import torch
    for _ in range(warm):
        fn()
    runs = []
    for _ in range(reps):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        runs.append(ev[0].elapsed_time(ev[1]))
    return float(np.median(runs))


def bfv_entry_points(ctx, m1, m2):
    """{name: tensor} of every BFV entry point (and the BFV gates) on ctx's
    device, keys and randomness from one DRBG seed (host draws, so a CPU and
    a card context get the same numbers), and the two noise budgets."""
    from heongpu_tpu_torch.models import bfv, logic
    from heongpu_tpu_torch.ops import polyops
    from heongpu_tpu_torch.utils import rng
    d = rng.new_drbg(b"chip_smoke phase 15 BFV entropy.")
    sk = bfv.keygen_secret(ctx, d)
    pk = bfv.keygen_public(ctx, d, sk)
    rk = bfv.keygen_relin(ctx, d, sk)
    gk = bfv.keygen_galois(ctx, d, sk, steps=[1, 2])
    gki = bfv.keygen_galois(ctx, d, sk, steps=[1], inv_form=True)
    swk = bfv.keygen_switch(ctx, d, sk, bfv.keygen_secret(ctx, d))
    p1, p2 = bfv.encode(ctx, m1), bfv.encode(ctx, m2)
    c1, c2 = bfv.encrypt(ctx, pk, p1, d), bfv.encrypt(ctx, pk, p2, d)
    prod = bfv.multiply(ctx, c1, c2)
    rel = bfv.relinearize(ctx, prod, rk)
    g1 = polyops.steps_to_galois_elt(1, ctx.n)
    h = bfv.hoist(ctx, c1)
    out = {"keygen_secret": sk.s_ntt_mont_qp, "keygen_public": pk.pk0, "keygen_relin": rk.k0,
           "keygen_galois": gk.keys[g1].k0, "keygen_galois_inv": gki.keys[g1].k0,
           "keygen_switch": swk.k0, "encode": p1, "encrypt": c1.c, "multiply": prod.c,
           "relinearize": rel.c, "decrypt": bfv.decrypt(ctx, sk, rel),
           "add": bfv.add(ctx, c1, c2).c, "sub": bfv.sub(ctx, c1, c2).c,
           "negate": bfv.negate(ctx, c1).c, "add_plain": bfv.add_plain(ctx, c1, p2).c,
           "sub_plain": bfv.sub_plain(ctx, c1, p2).c,
           "multiply_plain": bfv.multiply_plain(ctx, c1, p2).c,
           "apply_galois_inv": bfv.apply_galois(ctx, c1, gki.keys[g1]).c,
           "rotate_rows_3": bfv.rotate_rows(ctx, c1, gk, 3).c,
           "rotate_columns": bfv.rotate_columns(ctx, c1, gk).c,
           "switch_key": bfv.switch_key(ctx, c1, swk).c,
           "multiply_power_of_x": bfv.multiply_power_of_x(ctx, c1, 5).c,
           "transform_to_ntt": bfv.transform_to_ntt(ctx, c1).c,
           "transform_from_ntt": bfv.transform_from_ntt(ctx, bfv.transform_to_ntt(ctx, c2)).c,
           "hoist": h, "rotate_rows_hoisted": bfv.rotate_rows_hoisted(ctx, c1, h, gk.keys[g1]).c,
           "rotate_rows_hoisted_inv": bfv.rotate_rows_hoisted(ctx, c1, h, gki.keys[g1]).c}
    for gate in ("and", "or", "xor", "nand", "nor", "xnor"):
        out[f"bfv_{gate}"] = getattr(logic, f"bfv_{gate}")(ctx, c1, c2, rk).c
    out["bfv_not"] = logic.bfv_not(ctx, c1).c
    for gate in ("and", "or", "xor"):
        out[f"bfv_{gate}_plain"] = getattr(logic, f"bfv_{gate}_plain")(ctx, c1, p2).c
    return out, (bfv.noise_budget(ctx, sk, c1), bfv.noise_budget(ctx, sk, rel))


def bfv_phases(dev, card, errs, time_ntt, gen, n_small=256, n_full=BFV_N):
    """Phase 15: BFV.  (a) n_small, both methods: every entry point on the
    card against the CPU plain path, keys from one DRBG seed on both sides,
    identical residues; (b) n_full on the entry point's default chain
    (Method I): mult -> relin -> decrypt exact, rotate_rows by 1,
    rotate_columns and hoisted rotations exact, noise budget > 0, every launch
    at a new shape held against plain, the card's residues of mult+relin and
    of a rotation equal to the CPU plain path's, per-op times, device busy
    and idle share, key bytes; K1 and K2 timed at (b)'s new shapes against
    their plain versions and bounds; (c) n_full at the repo's BFV bench
    shape (Method II: K5 in the coefficient domain): the bench's rows, each
    the median of several calls (CUDA events).  Returns (the launches of
    (b)'s and (c)'s main-path runs, summed; record; K1's timing records)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import bfv
    from heongpu_tpu_torch.ops import polyops, rns
    from heongpu_tpu_torch.utils import params, rng
    rec = {}

    # -- 15. (a) card against CPU at n_small, both methods ---------------------
    t0 = time.perf_counter()
    t_small = params.plain_modulus_for(n_small, BFV_T_BITS)
    r = np.random.default_rng(15)
    m1, m2 = r.integers(0, t_small, n_small), r.integers(0, t_small, n_small)
    same_all, budgets = {}, {}
    for method in (dict(ks_type="I"), dict(ks_type="II", alpha=2)):
        mk = lambda d: bfv.make_context(n_small, t_small, q_bits=BFV_SMALL_Q_BITS, device=d,
                                        **method)
        cpu_out, cpu_nb = bfv_entry_points(mk("cpu"), m1, m2)
        with held_against_plain(f"BFV N={n_small} Method {method['ks_type']}", errs), \
                div_round_sites(f"BFV N={n_small} Method {method['ks_type']}"):
            out, nb = bfv_entry_points(mk(dev), m1, m2)
            torch.cuda.synchronize()
        diff = [k for k in out if not torch.equal(out[k].cpu(), cpu_out[k])]
        same_all[method["ks_type"]] = not diff
        budgets[method["ks_type"]] = (nb, cpu_nb)
        print(f"BFV (a) N={n_small} Method {method['ks_type']}: {len(out)} entry-point outputs "
              f"on the card identical to the CPU plain path's: {not diff} {diff or ''}; noise "
              f"budget fresh / after mult+relin {nb[0]:.6f} / {nb[1]:.6f} bits (CPU "
              f"{cpu_nb[0]:.6f} / {cpu_nb[1]:.6f})")
        if diff or max(abs(a - b) for a, b in zip(nb, cpu_nb)) > 1e-6:
            raise AssertionError(f"BFV (a) Method {method['ks_type']}: card and CPU differ: {diff}")
    rec[f"n{n_small}"] = {"identical_to_cpu": same_all, "noise_budget": budgets,
                          "seconds": time.perf_counter() - t0}

    # -- 15. (b) the default chain at n_full, Method I -------------------------------
    t0 = time.perf_counter()
    t = params.plain_modulus_for(n_full, BFV_T_BITS)
    ctx = bfv.make_context(n_full, t, device=dev)
    cctx = bfv.make_context(n_full, t, device="cpu")
    print(f"BFV (b) context N={n_full}: {ctx.k} Q primes of "
          f"{sorted({q.bit_length() for q in ctx.q_primes})} bits, {len(ctx.p_primes)} special, "
          f"Method {ctx.ks_type}, Bsk {ctx.bsk_k} + 1, t={t}; {time.perf_counter() - t0:.1f} s")
    g = rng.new_generator(151, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sk = bfv.keygen_secret(ctx, g)
    pk = bfv.keygen_public(ctx, g, sk)
    rk = bfv.keygen_relin(ctx, g, sk)
    gk = bfv.keygen_galois(ctx, g, sk, steps=[1])     # step 1 and conj, as the bench makes them
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t1
    key_bytes = {"relin": nbytes(rk.k0, rk.k1),
                 "galois": sum(nbytes(k.k0, k.k1) for k in gk.keys.values())}
    half = n_full // 2
    r = np.random.default_rng(16)
    m1, m2 = r.integers(0, t, n_full), r.integers(0, t, n_full)
    g1 = polyops.steps_to_galois_elt(1, n_full)
    rows = lambda m, s: np.concatenate([np.roll(m[:half], -s), np.roll(m[half:], -s)])
    kernels.reset_launches()
    t1 = time.perf_counter()
    with held_against_plain(f"BFV N={n_full} default chain", errs), \
            div_round_sites(f"BFV N={n_full} default chain"):
        c1 = bfv.encrypt(ctx, pk, bfv.encode(ctx, m1), g)
        c2 = bfv.encrypt(ctx, pk, bfv.encode(ctx, m2), g)
        rel = bfv.relinearize(ctx, bfv.multiply(ctx, c1, c2), rk)
        dec = {"mult_relin": (bfv.decode(ctx, bfv.decrypt(ctx, sk, rel)), m1 * m2 % t)}
        rot = bfv.rotate_rows(ctx, c1, gk, 1)
        dec["rotate_rows_1"] = (bfv.decode(ctx, bfv.decrypt(ctx, sk, rot)), rows(m1, 1))
        dec["rotate_columns"] = (bfv.decode(ctx, bfv.decrypt(ctx, sk, bfv.rotate_columns(
            ctx, c1, gk))), np.concatenate([m1[half:], m1[:half]]))
        h = bfv.hoist(ctx, c2)
        dec["rotate_rows_hoisted_1"] = (bfv.decode(ctx, bfv.decrypt(
            ctx, sk, bfv.rotate_rows_hoisted(ctx, c2, h, gk.keys[g1]))), rows(m2, 1))
        dec["rotate_columns_hoisted"] = (bfv.decode(ctx, bfv.decrypt(
            ctx, sk, bfv.rotate_rows_hoisted(ctx, c2, h, gk.keys[polyops.GALOIS_CONJ]))),
            np.concatenate([m2[half:], m2[:half]]))
        torch.cuda.synchronize()
        launches_b = dict(kernels.launches)
    wrong = [k for k, (got, want) in dec.items() if not np.array_equal(got, want)]
    nb = (bfv.noise_budget(ctx, sk, c1), bfv.noise_budget(ctx, sk, rel))
    print(f"BFV (b) main path N={n_full}: {time.perf_counter() - t1:.1f} s, launches "
          f"{launches_b}; exact: {sorted(set(dec) - set(wrong))}, wrong: {wrong or 'none'}; "
          f"noise budget fresh {nb[0]:.3f}, after mult+relin {nb[1]:.3f} bits; keygen "
          f"{keygen_s:.2f} s, relin key {key_bytes['relin'] / 1e6:.1f} MB, {len(gk.keys)} "
          f"Galois keys {key_bytes['galois'] / 1e6:.1f} MB [{card}]")
    if wrong or not nb[1] > 0:
        raise AssertionError(f"BFV (b): {wrong} decrypt wrong or the noise budget is spent")
    require_launched("BFV default chain", launches_b, ("ntt_fwd", "ntt_inv", "mac_keys",
                                                       "base_conv"))
    # mult+relin and one rotation on the CPU plain path, on copies of keys and inputs
    t1 = time.perf_counter()
    cpu = lambda c: bfv.Ciphertext(c.c.cpu(), c.size, c.in_ntt)
    same = (torch.equal(bfv.relinearize(cctx, bfv.multiply(cctx, cpu(c1), cpu(c2)),
                                        key_to(rk, "cpu")).c, rel.c.cpu())
            and torch.equal(bfv.apply_galois(cctx, cpu(c1), key_to(gk.keys[g1], "cpu")).c,
                            rot.c.cpu()))
    print(f"BFV (b) mult+relin and rotate_rows by 1 on the CPU plain path identical to the "
          f"card's: {same} ({time.perf_counter() - t1:.1f} s)")
    if not same:
        raise AssertionError("BFV (b): CPU and card residues differ")
    prod = bfv.multiply(ctx, c1, c2)
    ops = {"encrypt": lambda: bfv.encrypt(ctx, pk, bfv.encode(ctx, m1), g),
           "multiply": lambda: bfv.multiply(ctx, c1, c2),
           "relinearize": lambda: bfv.relinearize(ctx, prod, rk),
           "mult_relin": lambda: bfv.relinearize(ctx, bfv.multiply(ctx, c1, c2), rk),
           "rotate_rows_1": lambda: bfv.rotate_rows(ctx, c1, gk, 1),
           "rotate_columns": lambda: bfv.rotate_columns(ctx, c1, gk),
           "hoist": lambda: bfv.hoist(ctx, c2),
           "rotate_rows_hoisted": lambda: bfv.rotate_rows_hoisted(ctx, c2, h, gk.keys[g1]),
           "decrypt": lambda: bfv.decrypt(ctx, sk, rel)}
    ms_b = {k: median_ms(fn) for k, fn in ops.items()}
    print(f"time BFV (b) N={n_full} default chain, ms (median of 7): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms_b.items()) + f" [{card}]")
    prof_b = {}
    print_profile(f"BFV mult+relin N={n_full} default chain", ops["mult_relin"], 3, card, prof_b,
                  "mult_relin")
    print_profile(f"BFV rotate_rows by 1 N={n_full} default chain", ops["rotate_rows_1"], 3, card,
                  prof_b, "rotate_rows_1")
    # K1 over the Method-I digits, K2 mac_keys over 29 digits, base_conv, K6
    ntt_recs = {"ntt_fwd": [time_ntt(ctx.ntt_qp, ctx.k, False)]}
    bq, conv = ctx.base_qp, ctx.conv_q_bsk
    nd, nl = ctx.k, len(bq)
    dd, k0, k1 = (rand_residues(list(ctx.qp_primes) * nd, (nd * nl, n_full), gen, dev)
                  .view(nd, nl, n_full) for _ in range(3))
    shapes = {"mac_keys": (lambda: rns.mac_keys_cuda(dd, k0, k1, bq),
                           lambda: mac_keys_plain(dd, k0, k1, bq), f"{tuple(dd.shape)}",
                           bound(nbytes(dd, k0, k1, dd[:2], bq.p, bq.pinv, bq.mu),
                                 2 * dd.numel() * MAC_OPS + 2 * nl * n_full * FOLD_OPS))}
    # base_conv: q -> Bsk on an operand's 2 polys (the lift, unscaled), on the 3 polys
    # of the tensor product (the floor, scaled), Bsk -> q on 3 polys (unscaled)
    kq, kb = ctx.k, ctx.bsk_k
    zq = {b: rand_residues(list(ctx.q_primes) * b, (b * kq, n_full), gen, dev).view(b, kq, n_full)
          for b in (2, 3)}
    zb = rand_residues(list(ctx.bsk_primes[:kb]) * 3, (3 * kb, n_full), gen, dev).view(3, kb,
                                                                                       n_full)
    for z in zq.values():
        shapes.update(conv_shapes(conv, z))
    shapes.update(conv_shapes(ctx.conv_b_q, zb))
    # K6 on a Method-I keyswitch's two halves: one stage over 29 + 1 limbs
    x30 = rand_residues(list(ctx.qp_primes) * 2, (2 * nl, n_full), gen, dev).view(2, nl, n_full)
    shapes.update(div_shapes(ctx.div_p.chain, x30, "Method I"))
    kern = time_kernels(shapes, "BFV's default-chain", n_full, card, errs)
    del dd, k0, k1, zq, zb, x30
    rec[f"n{n_full}_default"] = {
        "q_primes": ctx.k, "p_primes": len(ctx.p_primes), "bsk": ctx.bsk_k + 1, "t": t,
        "launches": launches_b, "noise_budget": nb, "keygen_s": keygen_s,
        "key_bytes": key_bytes, "identical_to_cpu": same, "ms": ms_b, "profile": prof_b,
        "kernels": kern, "seconds": time.perf_counter() - t0}
    del ctx, cctx, sk, pk, rk, gk, c1, c2, rel, rot, h, prod, ops
    torch.cuda.empty_cache()

    # -- 15. (c) the bench shape at n_full, Method II ----------------------------------
    t0 = time.perf_counter()
    ctx = bfv.make_context(n_full, t, q_bits=BFV_BENCH_Q_BITS, ks_type="II",
                           alpha=BFV_BENCH_ALPHA, device=dev)
    g = rng.new_generator(152, dev)
    sk = bfv.keygen_secret(ctx, g)
    pk = bfv.keygen_public(ctx, g, sk)
    rk = bfv.keygen_relin(ctx, g, sk)
    gk = bfv.keygen_galois(ctx, g, sk, steps=[1])
    g1k = gk.keys[g1]
    key_bytes = {"relin": nbytes(rk.k0, rk.k1),
                 "galois": sum(nbytes(k.k0, k.k1) for k in gk.keys.values())}
    kernels.reset_launches()
    with held_against_plain(f"BFV N={n_full} bench shape", errs), \
            div_round_sites(f"BFV N={n_full} bench shape"):
        c1 = bfv.encrypt(ctx, pk, bfv.encode(ctx, m1), g)
        c2 = bfv.encrypt(ctx, pk, bfv.encode(ctx, m2), g)
        dec = {"add": (bfv.add(ctx, c1, c2), (m1 + m2) % t),
               "mult_relin": (bfv.relinearize(ctx, bfv.multiply(ctx, c1, c2), rk), m1 * m2 % t),
               "rotate": (bfv.apply_galois(ctx, c1, g1k), rows(m1, 1))}
        dec = {k: (bfv.decode(ctx, bfv.decrypt(ctx, sk, c)), w) for k, (c, w) in dec.items()}
        torch.cuda.synchronize()
        launches_c = dict(kernels.launches)
    wrong = [k for k, (got, want) in dec.items() if not np.array_equal(got, want)]
    print(f"BFV (c) bench shape N={n_full}, {len(BFV_BENCH_Q_BITS)} x 29-bit Q, Method II alpha "
          f"{BFV_BENCH_ALPHA} ({len(ctx.ks2[0].groups)} digits over {len(ctx.qp_primes)} limbs): "
          f"launches {launches_c}; wrong: {wrong or 'none'}; relin key "
          f"{key_bytes['relin'] / 1e6:.1f} MB, {len(gk.keys)} Galois keys "
          f"{key_bytes['galois'] / 1e6:.1f} MB [{card}]")
    if wrong:
        raise AssertionError(f"BFV (c): {wrong} decrypt wrong")
    require_launched("BFV bench shape", launches_c, ("ntt_fwd", "ntt_inv", "base_conv",
                                                     "keyswitch2_fused"))
    rows_c = {"encrypt": lambda: bfv.encrypt(ctx, pk, bfv.encode(ctx, m1), g),
              "add": lambda: bfv.add(ctx, c1, c2),
              "multiply": lambda: bfv.multiply(ctx, c1, c2),
              "mult_relin": lambda: bfv.relinearize(ctx, bfv.multiply(ctx, c1, c2), rk),
              "rotate": lambda: bfv.apply_galois(ctx, c1, g1k),
              "decrypt": lambda: bfv.decrypt(ctx, sk, c1)}
    ms_c = {k: median_ms(fn, reps=10) for k, fn in rows_c.items()}
    print(f"time BFV (c) bench shape N={n_full}, ms (median of 10): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms_c.items()) + f" [{card}]")
    prof_c = {}
    print_profile(f"BFV mult+relin N={n_full} bench shape", rows_c["mult_relin"], 3, card, prof_c,
                  "mult_relin")
    rec[f"n{n_full}_bench"] = {"launches": launches_c, "ms": ms_c, "profile": prof_c,
                               "key_bytes": key_bytes, "seconds": time.perf_counter() - t0}
    del ctx, sk, pk, rk, gk, g1k, c1, c2
    torch.cuda.empty_cache()
    return {k: launches_b[k] + launches_c[k] for k in launches_b}, rec, ntt_recs


def ckks_method1_phase(dev, card, errs, n=N):
    """Phase 16: CKKS with Method-I keyswitching (the default of make_context)
    at the main path's shape: mult -> relin -> rescale, rotate by 1,
    rotate_hoisted and conjugate, every launch at a new shape held against
    plain, launches counted from 0 (ntt_fwd, ntt_inv and mac_keys must
    launch; a Method-I keyswitch runs no K5), decode within TOL_DECODE (+
    4·keyswitch_noise for one keyswitch), the card's residues equal to the
    CPU plain path's; per-op times, device busy and idle share, key bytes.
    Returns (launches of the path; record)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.ops import polyops
    from heongpu_tpu_torch.utils import rng
    t0 = time.perf_counter()
    ctx = ckks.make_context(n, Q_BITS, device=dev)
    if ctx.ks_type != "I":
        raise AssertionError("make_context with no ks_type did not build a Method-I context")
    g = rng.new_generator(161, dev)
    sk = ckks.keygen_secret(ctx, g)
    pk = ckks.keygen_public(ctx, g, sk)
    rk = ckks.keygen_relin(ctx, g, sk)
    gk = ckks.keygen_galois(ctx, g, sk, steps=[1])
    torch.cuda.synchronize()
    key_bytes = {"relin": nbytes(rk.k0, rk.k1),
                 "galois": sum(nbytes(k.k0, k.k1) for k in gk.keys.values())}
    g1 = polyops.steps_to_galois_elt(1, n)
    z = np.linspace(-1.0, 1.0, n // 2)
    ks_noise = keyswitch_noise(ctx)
    kernels.reset_launches()
    t1 = time.perf_counter()
    with held_against_plain(f"CKKS Method I N={n}", errs), div_round_sites(f"CKKS Method I N={n}"):
        ct1 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z), g)
        ct2 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z[::-1].copy()), g)
        relin = ckks.relinearize(ctx, ckks.multiply(ctx, ct1, ct2), rk)
        res = ckks.rescale(ctx, relin)
        rot = ckks.rotate(ctx, ct1, gk, 1)
        d = ckks.hoist(ctx, ct1)
        hrot = ckks.rotate_hoisted(ctx, ct1, d, gk.keys[g1])
        conj = ckks.conjugate(ctx, ct1, gk)
        dec = lambda c: ckks.decode(ctx, ckks.decrypt(ctx, sk, c))
        got = {"mult_relin_rescale": (dec(res), z * z[::-1], 0), "rotate_1": (dec(rot), np.roll(z, -1), 1),
               "rotate_hoisted_1": (dec(hrot), np.roll(z, -1), 1), "conjugate": (dec(conj), z, 1)}
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
    errs_dec = {k: float(np.abs(v - w).max()) for k, (v, w, _) in got.items()}
    limit = {k: TOL_DECODE + 4 * ks * ks_noise for k, (_, _, ks) in got.items()}
    print(f"CKKS Method I N={n}, {len(Q_BITS)} x 29-bit Q, {len(ctx.p_primes)} special prime, "
          f"{ctx.k} digits: {time.perf_counter() - t1:.1f} s, launches {launches}; decode "
          "errors " + ", ".join(f"{k} {e:.3e} (limit {limit[k]:.3e})" for k, e in errs_dec.items())
          + f"; keyswitch_noise {ks_noise:.3e}; relin key {key_bytes['relin'] / 1e6:.1f} MB, "
          f"{len(gk.keys)} Galois keys {key_bytes['galois'] / 1e6:.1f} MB [{card}]")
    require_launched("CKKS Method I", launches, ("ntt_fwd", "ntt_inv", "mac_keys"))
    if not all(np.isfinite(v).all() and v.shape == (n // 2,) for v, _, _ in got.values()):
        raise AssertionError("CKKS Method I: decode gave non-finite values or the wrong shape")
    if any(e > limit[k] for k, e in errs_dec.items()):
        raise AssertionError(f"CKKS Method I: a decode error above its limit: {errs_dec}")
    t1 = time.perf_counter()
    cctx = ckks.make_context(n, Q_BITS, device="cpu")
    cpu = lambda c: ckks.Ciphertext(c.c.cpu(), c.size, c.level, c.scale)
    cg1 = key_to(gk.keys[g1], "cpu")
    c_relin = ckks.relinearize(cctx, ckks.multiply(cctx, cpu(ct1), cpu(ct2)), key_to(rk, "cpu"))
    same = (torch.equal(c_relin.c, relin.c.cpu())
            and torch.equal(ckks.rescale(cctx, c_relin).c, res.c.cpu())
            and torch.equal(ckks.apply_galois(cctx, cpu(ct1), cg1).c, rot.c.cpu())
            and torch.equal(ckks.rotate_hoisted(cctx, cpu(ct1), ckks.hoist(cctx, cpu(ct1)), cg1).c,
                            hrot.c.cpu()))
    print(f"CKKS Method I mult+relin+rescale, rotate and rotate_hoisted on the CPU plain path "
          f"identical to the card's: {same} ({time.perf_counter() - t1:.1f} s)")
    if not same:
        raise AssertionError("CKKS Method I: CPU and card residues differ")
    ops = {"mult_relin": lambda: ckks.relinearize(ctx, ckks.multiply(ctx, ct1, ct2), rk),
           "rescale": lambda: ckks.rescale(ctx, relin),
           "rotate_1": lambda: ckks.rotate(ctx, ct1, gk, 1),
           "hoist": lambda: ckks.hoist(ctx, ct1),
           "rotate_hoisted": lambda: ckks.rotate_hoisted(ctx, ct1, d, gk.keys[g1]),
           "conjugate": lambda: ckks.conjugate(ctx, ct1, gk)}
    ms = {k: median_ms(fn) for k, fn in ops.items()}
    print(f"time CKKS Method I N={n}, ms (median of 7): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + f" [{card}]")
    prof = {}
    print_profile(f"CKKS Method I mult+relin N={n}", ops["mult_relin"], 5, card, prof, "mult_relin")
    print_profile(f"CKKS Method I rotate by 1 N={n}", ops["rotate_1"], 5, card, prof, "rotate_1")
    rec = {"launches": launches, "decode_max_abs_err": errs_dec, "keyswitch_noise": ks_noise,
           "key_bytes": key_bytes, "identical_to_cpu": same, "ms": ms, "profile": prof,
           "seconds": time.perf_counter() - t0}
    del ctx, cctx, sk, pk, rk, gk, ct1, ct2, relin, res, rot, d, hrot, conj
    torch.cuda.empty_cache()
    return launches, rec


# BGV (phase 17): every division t-exact, on K6's t-exact mode.  The full-width
# chain is the default 128-bit one of BFV phase 15: 29 Q primes of 29 bits and
# one 30-bit special prime (871 bits, tc128 at N=2^15), t = plain_modulus_for(N, 20).
BGV_N = 1 << 15
BGV_Q_BITS = [29] * 29
BGV_SEC = "tc128"
BGV_SMALL_Q_BITS = [29] * 4     # tests/test_bgv.py's chain: the N=256 card-against-CPU run
# Squarings at full width, each multiply -> relinearize -> mod_switch -> mod_switch: a
# square's noise is about N·e^2, and one switch (29 bits) would leave the noise's bit
# count nearly doubled at every step (the chain's 841 Q bits run out after five
# squarings); two switches bring it back to the rounding noise t·|s| of a switch.
BGV_CHAIN = 8
BGV_SWITCHES = 2
# The launches of each BGV op on the card (K1 both ways, K2 mac_keys, K6 t-exact):
# multiply transforms both operands and inverts the three products; a keyswitch
# (relinearize, a rotation) transforms the digits, MACs, inverts and divides;
# encryption transforms u, inverts both halves and divides; mod_switch divides.
BGV_OP_LAUNCHES = {
    "encrypt": {"ntt_fwd": 1, "ntt_inv": 1, "div_exact_t": 1},
    "multiply": {"ntt_fwd": 2, "ntt_inv": 1},
    "relinearize": {"ntt_fwd": 1, "mac_keys": 1, "ntt_inv": 1, "div_exact_t": 1},
    "mod_switch": {"div_exact_t": 1},
    "rotate_rows": {"ntt_fwd": 1, "mac_keys": 1, "ntt_inv": 1, "div_exact_t": 1},
    "multiply_plain": {"ntt_fwd": 2, "ntt_inv": 1},
    "add_plain": {},
    "decrypt": {"ntt_fwd": 1, "ntt_inv": 1},
}


def div_exact_bound(x, chain):
    """K6's bound in its t-exact mode on x (B, k+p, N): x, the table and the
    output once; each stage's centered v per column and update of each Q word
    and of the special words still present."""
    p, k, n = len(chain), chain.k, x.shape[-1]
    b = x.numel() // ((k + p) * n)
    return bound(nbytes(x, chain.tab) + b * k * n * 4,
                 b * n * ((k * p + p * (p - 1) // 2) * EXACT_OPS + p * (SHOUP_OPS + 3)))


def exact_shapes(chain, x, label):
    """A time_kernels entry for K6's t-exact mode on x."""
    from heongpu_tpu_torch.ops import rns
    return {f"div_exact_t {label}": (
        lambda: rns.div_round_cuda(x, chain), lambda: rns.div_round_chain_plain(x, chain),
        f"{tuple(x.shape)} -> {tuple(x.shape[:-2]) + (chain.k, x.shape[-1])}, p={len(chain)}",
        div_exact_bound(x, chain))}


def threefry_shapes(primes, shape, dev, label, seed=2 ** 34 + 13, rows=None):
    """A time_kernels entry for K7: a seeded key's uniform half at `shape`
    ((d, n), moved behind the digit axis, Montgomery form), with its bound:
    the words written once (K7 reads nothing but its key and table) against
    its operations.  rows=(first, count): only those limbs of the draw over
    `primes` (a rank's block of a limb-sharded key), labelled
    "threefry_uniform rows"."""
    from heongpu_tpu_torch.utils import threefry
    key = threefry.key_from_seed(seed)
    lb, lc = (0, len(primes)) if rows is None else rows
    words = lc * int(np.prod(shape))
    what = f"{tuple(shape)} x {len(primes)} limbs -> {(shape[0], lc) + tuple(shape[1:])}"
    return {f"threefry_uniform {'' if rows is None else 'rows '}{label}": (
        lambda: threefry.uniform_rns_cuda(key, primes, shape, dev, True, True, rows),
        lambda: threefry.uniform_rns_plain(key, primes, shape, dev, True, True, rows),
        what + ("" if rows is None else f", rows {lb}..{lb + lc - 1}"),
        bound(words * 4 + lc * 16, words * (THREEFRY_OPS + MONT_OPS),
              words * (THREEFRY_ALU_OPS + MONT_ALU_OPS)))}


def bgv_entry_points(ctx, m1, m2):
    """{name: tensor} of every BGV entry point on ctx's device, keys and
    randomness from one DRBG seed (host draws, so a CPU and a card context get
    the same numbers); {name: (level, factor)} of the ciphertexts; the noise
    budgets."""
    from heongpu_tpu_torch.models import bgv, ringkit
    from heongpu_tpu_torch.utils import rng
    d = rng.new_drbg(b"chip_smoke phase 17 BGV entropy.")
    sk = bgv.keygen_secret(ctx, d)
    pk = bgv.keygen_public(ctx, d, sk)
    rk = bgv.keygen_relin(ctx, d, sk)
    rk_seeded = bgv.keygen_relin(ctx, d, sk, a_seed=2 ** 34 + 17)
    gk = bgv.keygen_galois(ctx, d, sk, steps=[1, 2])
    gki = bgv.keygen_galois(ctx, d, sk, steps=[1], inv_form=True)
    g1 = bgv.polyops.steps_to_galois_elt(1, ctx.n)
    p1, p2 = bgv.encode(ctx, m1), bgv.encode(ctx, m2)
    c1, c2 = bgv.encrypt(ctx, pk, p1, d), bgv.encrypt(ctx, pk, p2, d)
    prod = bgv.multiply(ctx, c1, c2)
    cts = {"encrypt": c1, "add": bgv.add(ctx, c1, c2), "sub": bgv.sub(ctx, c1, c2),
           "negate": bgv.negate(ctx, c1), "add_plain": bgv.add_plain(ctx, c1, p2),
           "sub_plain": bgv.sub_plain(ctx, c1, p2),
           "multiply_plain": bgv.multiply_plain(ctx, c1, p2), "multiply": prod,
           "relinearize": bgv.relinearize(ctx, prod, rk),
           "relinearize_stripped_seeded": bgv.relinearize(ctx, prod,
                                                          ringkit.strip_seeded(rk_seeded)),
           "apply_galois": bgv.apply_galois(ctx, c1, gk.keys[g1]),
           "apply_galois_inv": bgv.apply_galois(ctx, c1, gki.keys[g1]),
           "rotate_rows_3": bgv.rotate_rows(ctx, c1, gk, 3)}
    a, b = c1, c2
    for level in (1, 2):
        a, b = bgv.mod_switch(ctx, a), bgv.mod_switch(ctx, b)
        cts[f"mod_switch_{level}"] = a
        cts[f"mult_relin_level_{level}"] = bgv.relinearize(ctx, bgv.multiply(ctx, a, b), rk)
        cts[f"add_plain_level_{level}"] = bgv.add_plain(ctx, a, p2)
        cts[f"rotate_rows_1_level_{level}"] = bgv.rotate_rows(ctx, a, gk, 1)
    out = {k: c.c for k, c in cts.items()}
    out.update(keygen_secret=sk.s_ntt_mont_qp, keygen_public=pk.pk0, keygen_relin=rk.k0,
               keygen_relin_seeded=rk_seeded.k1, keygen_galois=gk.keys[g1].k0,
               keygen_galois_inv=gki.keys[g1].k0, encode=p1,
               decrypt=bgv.decrypt(ctx, sk, cts["relinearize"]),
               decrypt_level_2=bgv.decrypt(ctx, sk, cts["mult_relin_level_2"]))
    meta = {k: (c.level, c.factor) for k, c in cts.items()}
    budgets = (bgv.noise_budget(ctx, sk, c1), bgv.noise_budget(ctx, sk, cts["relinearize"]),
               bgv.noise_budget(ctx, sk, cts["mult_relin_level_2"]))
    return out, meta, budgets


def bgv_phases(dev, card, errs, gen, n_small=256, n_full=BGV_N):
    """Phase 17: BGV.  (a) n_small: every entry point on the card against the
    CPU plain path, keys from one DRBG seed on both sides: identical residues,
    levels and factors, noise budgets within 1e-9 bits; (b) n_full on the
    871-bit tc128 chain: BGV_CHAIN squarings (multiply -> relinearize ->
    BGV_SWITCHES x mod_switch), then
    rotate_rows by 1, multiply_plain and add_plain, each op's launches counted
    and held to BGV_OP_LAUNCHES, every launch at a new shape held against
    plain, K6's launches against BGV's division sites, decrypted exactly against
    numpy slot arithmetic mod t, the noise budget after each step; per-op
    medians (CUDA events), device busy and idle share, key bytes; K6's t-exact
    mode and K7 timed at BGV's shapes.  Returns (the launches of (b)'s run;
    record; the kernel timings)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import bgv
    from heongpu_tpu_torch.utils import params, rng
    rec = {}

    # -- 17. (a) card against CPU at n_small ------------------------------------------
    t0 = time.perf_counter()
    t_small = params.plain_modulus_for(n_small, 20)
    r = np.random.default_rng(17)
    m1, m2 = r.integers(0, t_small, n_small), r.integers(0, t_small, n_small)
    mk = lambda d: bgv.make_context(n_small, t_small, q_bits=BGV_SMALL_Q_BITS, device=d)
    cpu_out, cpu_meta, cpu_nb = bgv_entry_points(mk("cpu"), m1, m2)
    with held_against_plain(f"BGV N={n_small}", errs), div_round_sites(f"BGV N={n_small}"):
        out, meta, nb = bgv_entry_points(mk(dev), m1, m2)
        torch.cuda.synchronize()
    diff = [k for k in out if not torch.equal(out[k].cpu(), cpu_out[k])]
    diff += [k for k in meta if meta[k] != cpu_meta[k]]
    print(f"BGV (a) N={n_small}, {len(BGV_SMALL_Q_BITS)} x 29-bit Q: {len(out)} entry-point "
          f"outputs and {len(meta)} (level, factor) pairs on the card identical to the CPU plain "
          f"path's: {not diff} {diff or ''}; noise budget fresh / after mult+relin / at level 2 "
          f"{nb[0]:.6f} / {nb[1]:.6f} / {nb[2]:.6f} bits (CPU {cpu_nb[0]:.6f} / {cpu_nb[1]:.6f} / "
          f"{cpu_nb[2]:.6f}); {time.perf_counter() - t0:.1f} s")
    if diff or max(abs(a - b) for a, b in zip(nb, cpu_nb)) > 1e-9:
        raise AssertionError(f"BGV (a): card and CPU differ: {diff} {nb} {cpu_nb}")
    rec[f"n{n_small}"] = {"identical_to_cpu": True, "noise_budget": nb,
                          "seconds": time.perf_counter() - t0}

    # -- 17. (b) the 871-bit chain at n_full -----------------------------------------
    t0 = time.perf_counter()
    t = params.plain_modulus_for(n_full, 20)
    ctx = bgv.make_context(n_full, t, q_bits=BGV_Q_BITS, sec_level=BGV_SEC, device=dev)
    bits = sum(q.bit_length() for q in ctx.qp_primes)
    g = rng.new_generator(171, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sk = bgv.keygen_secret(ctx, g)
    pk = bgv.keygen_public(ctx, g, sk)
    rk = bgv.keygen_relin(ctx, g, sk)
    gk = bgv.keygen_galois(ctx, g, sk, steps=[1])
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t1
    key_bytes = {"relin": nbytes(rk.k0, rk.k1),
                 "galois": sum(nbytes(k.k0, k.k1) for k in gk.keys.values())}
    print(f"BGV (b) context N={n_full}: {ctx.k} Q primes of 29 bits and {len(ctx.p_primes)} "
          f"special, {bits} bits, t={t}; keygen {keygen_s:.2f} s, relin key "
          f"{key_bytes['relin'] / 1e6:.1f} MB, {len(gk.keys)} Galois keys "
          f"{key_bytes['galois'] / 1e6:.1f} MB [{card}]")
    half = n_full // 2
    r = np.random.default_rng(18)
    m1, m2, m3 = (r.integers(0, t, n_full) for _ in range(3))
    p2, p3 = bgv.encode(ctx, m2), bgv.encode(ctx, m3)
    op_launches, budgets = {}, []

    def op(name, fn, *args):
        before = dict(kernels.launches)
        res = fn(ctx, *args)
        got = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
        op_launches.setdefault(name, []).append(got)
        if got != BGV_OP_LAUNCHES[name]:
            raise AssertionError(f"BGV {name} launched {got}, predicted {BGV_OP_LAUNCHES[name]}")
        return res

    want = m1 % t
    kernels.reset_launches()
    t1 = time.perf_counter()
    with held_against_plain(f"BGV N={n_full}", errs), div_round_sites(f"BGV N={n_full}"):
        c = op("encrypt", bgv.encrypt, pk, bgv.encode(ctx, m1), g)
        budgets.append(("fresh", c.level, bgv.noise_budget(ctx, sk, c)))
        for i in range(BGV_CHAIN):
            c = op("multiply", bgv.multiply, c, c)
            c = op("relinearize", bgv.relinearize, c, rk)
            for _ in range(BGV_SWITCHES):
                c = op("mod_switch", bgv.mod_switch, c)
            want = want * want % t
            budgets.append((f"square {i + 1}", c.level, bgv.noise_budget(ctx, sk, c)))
        c = op("rotate_rows", bgv.rotate_rows, c, gk, 1)
        want = np.concatenate([np.roll(want[:half], -1), np.roll(want[half:], -1)])
        budgets.append(("rotate_rows 1", c.level, bgv.noise_budget(ctx, sk, c)))
        c = op("multiply_plain", bgv.multiply_plain, c, p2)
        want = want * m2 % t
        budgets.append(("multiply_plain", c.level, bgv.noise_budget(ctx, sk, c)))
        c = op("add_plain", bgv.add_plain, c, p3)
        want = (want + m3) % t
        budgets.append(("add_plain", c.level, bgv.noise_budget(ctx, sk, c)))
        dec = bgv.decode(ctx, op("decrypt", bgv.decrypt, sk, c))
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
    exact = np.array_equal(dec, want.astype(np.uint32))
    print(f"BGV (b) main path N={n_full}: {time.perf_counter() - t1:.1f} s, launches {launches}; "
          f"each op's launches as predicted {BGV_OP_LAUNCHES}; {BGV_CHAIN} x (multiply -> "
          f"relinearize -> {BGV_SWITCHES} x mod_switch), rotate_rows 1, multiply_plain, add_plain "
          f"decrypt exactly "
          f"against numpy mod t: {exact}; level {c.level}, factor {c.factor}; noise budget "
          + ", ".join(f"{w} (level {lv}) {b:.3f}" for w, lv, b in budgets) + f" bits [{card}]")
    if not exact or not budgets[-1][2] > 0:
        raise AssertionError("BGV (b): the chain decrypts wrong or its noise budget is spent")
    require_launched("BGV chain", launches, ("ntt_fwd", "ntt_inv", "mac_keys", "div_exact_t"))
    # per-op medians at level 0, and the profile of mult+relin and of a rotation
    c1 = bgv.encrypt(ctx, pk, bgv.encode(ctx, m1), g)
    c2 = bgv.encrypt(ctx, pk, p2, g)
    prod = bgv.multiply(ctx, c1, c2)
    rel = bgv.relinearize(ctx, prod, rk)
    ops = {"encrypt": lambda: bgv.encrypt(ctx, pk, p2, g),
           "multiply": lambda: bgv.multiply(ctx, c1, c2),
           "relinearize": lambda: bgv.relinearize(ctx, prod, rk),
           "mod_switch": lambda: bgv.mod_switch(ctx, rel),
           "mult_relin_mod_switch": lambda: bgv.mod_switch(
               ctx, bgv.relinearize(ctx, bgv.multiply(ctx, c1, c2), rk)),
           "rotate_rows_1": lambda: bgv.rotate_rows(ctx, c1, gk, 1),
           "multiply_plain": lambda: bgv.multiply_plain(ctx, c1, p2),
           "add_plain": lambda: bgv.add_plain(ctx, c1, p3),
           "decrypt": lambda: bgv.decrypt(ctx, sk, rel)}
    ms = {k: median_ms(fn) for k, fn in ops.items()}
    print(f"time BGV N={n_full} level 0, ms (median of 7): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + f" [{card}]")
    prof = {}
    print_profile(f"BGV mult+relin+mod_switch N={n_full}", ops["mult_relin_mod_switch"], 3, card,
                  prof, "mult_relin")
    print_profile(f"BGV rotate_rows by 1 N={n_full}", ops["rotate_rows_1"], 3, card, prof,
                  "rotate_rows_1")
    # K6 t-exact on a keyswitch's two halves (2, 30, 2^15) -> (2, 29) and on a mod
    # switch's (2, 29, 2^15) -> (2, 28); K7 at the relin key's shape (29 digits, 30 limbs)
    qp = list(ctx.qp_primes)
    x30 = rand_residues(qp * 2, (2 * len(qp), n_full), gen, dev).view(2, len(qp), n_full)
    x29 = rand_residues(qp[:-1] * 2, (2 * ctx.k, n_full), gen, dev).view(2, ctx.k, n_full)
    shapes = exact_shapes(ctx.div_p_lvl[0].chain, x30, "keyswitch")
    shapes.update(exact_shapes(ctx.mod_sw[0].chain, x29, "mod_switch"))
    shapes.update(threefry_shapes(qp, (ctx.k, n_full), dev, "BGV relin key"))
    kern = time_kernels(shapes, "BGV's", n_full, card, errs)
    rec[f"n{n_full}"] = {"q_primes": ctx.k, "bits": bits, "t": t, "launches": launches,
                         "op_launches": {k: v[0] for k, v in op_launches.items()},
                         "noise_budget": budgets, "exact": exact, "keygen_s": keygen_s,
                         "key_bytes": key_bytes, "ms": ms, "profile": prof, "kernels": kern,
                         "seconds": time.perf_counter() - t0}
    del ctx, sk, pk, rk, gk, c, c1, c2, prod, rel, ops, x30, x29
    torch.cuda.empty_cache()
    return launches, rec, kern


# MPC (phase 18): three parties, N-out-of-N and t-out-of-N, every key, share and
# mask from Threefry keys (rng.new_key), as the JAX package's MPC tests and
# examples draw them.  (a) N=256 on tests/test_mpc.py's chains; (b) BFV on phase
# 15's default chain at N=2^15; (c) CKKS Method I on phase 16's shape at N=2^16.
MPC_PARTIES = 3
MPC_SMALL_BFV_Q_BITS = [29] * 3
MPC_SMALL_T_BITS = 16
MPC_SMALL_CKKS_Q_BITS = [29, 25, 25, 25]
MPC_TOL = 5e-2          # tests/test_mpc.py:138,149: the parties' flooding of ±2^13
MPC_SEED = 1800         # party i's keys: rng.new_key(MPC_SEED + 10·step + i)
MPC_CRS = 777           # the common reference strings' seeds start here
MPC_GROUP = (2, 4, 5)   # BFV's 3 of 5
MPC_CKKS_GROUP = (1, 3)  # CKKS's 2 of 3


def mpc_k7_predicted(name, n, threshold=0):
    """(K7 uniform launches, K7 raw-words launches) of one call of an MPC
    step on Threefry keys, counted from the code: a uniform RNS draw is one
    uniform launch; a normal draw (each gaussian) one words launch, randint
    two, permutation one a sort round."""
    from heongpu_tpu_torch.utils import threefry
    rounds = threefry.permutation_rounds(n)
    words = {"keygen_secret": rounds + 2, "ternary_hw": rounds + 2, "permutation": rounds,
             "pk_share": 1, "galois_share": 1, "normal": 1, "gaussian_rns": 1, "bits32": 1,
             "randint": 2, "relin_round1": 2 + 1 + 1, "relin_round2": 2,
             "encrypt": 2 + 1 + 1,  # ternary u, e0, e1
             "bfv_decrypt_partial": 4, "bfv_decrypt_partial_threshold": 4,  # 30 + 10 bits
             "ckks_decrypt_partial": 2, "ckks_decrypt_partial_threshold": 2,  # 13 bits
             "bfv_colboot_participant": 2 + 4 + 1, "ckks_colboot_participant": 2 + 2 + 1}
    uniform = {"crs_uniform": 1, "relin_crs": 1, "bfv_colboot_participant": 1,
               "ckks_colboot_participant": 1, "bfv_colboot_coordinator": 1,
               "ckks_colboot_coordinator": 1, "shamir_share_secret": threshold - 1}
    return uniform.get(name, 0), words.get(name, 0)


def mpc_stepper(n, record, check=True, calls=None):
    """step(name, fn, *args, threshold=0): runs fn(*args), records the
    kernel launches of the call under `name` in record[name] (the first
    call's), and with `check` raises unless its K7 launches (uniform, words)
    are mpc_k7_predicted's.  With `calls`, calls[name] keeps the first
    call as a function of no arguments, for the timings."""
    from heongpu_tpu_torch import kernels

    def step(name, fn, *args, threshold=0):
        before = dict(kernels.launches)
        out = fn(*args)
        got = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
        record.setdefault(name, got)
        if calls is not None:
            calls.setdefault(name, lambda: fn(*args))
        have = (got.get("threefry_uniform", 0), got.get("threefry_bits", 0))
        want = mpc_k7_predicted(name, n, threshold)
        if check and have != want:
            raise AssertionError(f"MPC {name}: K7 launched (uniform, words) {have}, "
                                 f"predicted {want}")
        return out
    return step


def card_device(device) -> bool:
    """Whether draws for `device` are draws on the card."""
    import torch
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def plain_threefry_on_card(what):
    """Counts the plain Threefry passes (threefry.bits32_plain and
    uniform_rns_plain) that the block runs for the card, and raises unless
    there are none: every Threefry draw of the block on the card was a K7
    launch.  Enter it inside held_against_plain, whose comparisons call the
    plain versions it took before and are not counted.  The word draws of a
    plain uniform pass are part of that pass and not counted apart."""
    from heongpu_tpu_torch.utils import threefry
    counts, saved = {"bits32_plain": 0, "uniform_rns_plain": 0}, []
    uniform_pass = threefry.uniform_rns_plain.__code__
    for name in counts:
        f = getattr(threefry, name)

        def counted(key, primes_or_shape, *a, _f=f, _name=name, **k):
            device = a[0] if _name == "bits32_plain" else (a[1] if len(a) > 1 else k["device"])
            if card_device(device) and sys._getframe(1).f_code is not uniform_pass:
                counts[_name] += 1
            return _f(key, primes_or_shape, *a, **k)
        saved.append((name, f))
        setattr(threefry, name, counted)
    try:
        yield counts
    finally:
        for name, f in saved:
            setattr(threefry, name, f)
    print(f"{what}: plain Threefry passes on the card {counts}")
    if any(counts.values()):
        raise AssertionError(f"{what}: Threefry draws on the card ran the plain version {counts}")


def threefry_bits_shapes(shape, dev, label, seed=2 ** 34 + 19):
    """A time_kernels entry for K7's raw-words mode at `shape`, with its
    bound: the words written once against one hash a word."""
    from heongpu_tpu_torch.utils import threefry
    key = threefry.key_from_seed(seed)
    words = int(np.prod(shape))
    return {f"threefry_bits {label}": (
        lambda: threefry.bits32_cuda(key, shape, dev),
        lambda: threefry.bits32_plain(key, shape, dev), f"{tuple(shape)} words",
        bound(words * 4, words * THREEFRY_WORD_OPS, words * THREEFRY_WORD_ALU_OPS))}


def joint_secret(ring, sks):
    """The oracle joint key Σ s_i (coefficients and NTT + Montgomery form
    add limb by limb), as tests/test_mpc.py builds it for the noise budget."""
    import torch
    from heongpu_tpu_torch.models import ringkit
    from heongpu_tpu_torch.ops import modmath as mm
    p = ring.base_qp.col()
    s = sks[0].s_ntt_mont_qp
    for sk in sks[1:]:
        s = mm.add_mod(s, sk.s_ntt_mont_qp, p)
    return ringkit.SecretKey(sum(sk.s_coeff.long() for sk in sks).to(torch.int32), s, 0)


def mpc_bfv_run(ctx, step, seed=MPC_SEED):
    """Three parties on a BFV context: their keys, the collective public key,
    the 2-round relin key, a collective Galois key for rotate_rows by 1;
    encrypt -> multiply -> relinearize -> rotate_rows by 1; threshold
    decryption; collective bootstrapping and threshold decryption again;
    Shamir 3 of 5 over the joint key and decryption by MPC_GROUP.  Every step
    through `step` (mpc_stepper).  Returns {name: value} of every result."""
    from heongpu_tpu_torch.models import bfv, mpc, ringkit
    from heongpu_tpu_torch.ops import modmath as mm
    from heongpu_tpu_torch.ops import polyops
    from heongpu_tpu_torch.utils import rng
    key = lambda s: rng.new_key(s, ctx.device)
    ring, n, t = bfv._ring(ctx), ctx.n, ctx.t
    parties = range(MPC_PARTIES)
    o = {"sks": [step("keygen_secret", ringkit.keygen_secret, ring, key(seed + i))
                 for i in parties]}
    o["a"] = step("crs_uniform", mpc.crs_uniform, ring, MPC_CRS, (n,))
    o["pk_shares"] = [step("pk_share", mpc.pk_share, ring, sk, o["a"], key(seed + 10 + i))
                      for i, sk in enumerate(o["sks"])]
    o["pk"] = step("pk_assemble", mpc.pk_assemble, ring, o["pk_shares"], o["a"])
    o["a_d"] = step("relin_crs", mpc.relin_crs, ring, MPC_CRS + 1)
    o["round1"] = [step("relin_round1", mpc.relin_round1, ring, sk, o["a_d"], key(seed + 20 + i))
                   for i, sk in enumerate(o["sks"])]
    p = ring.base_qp.col()
    d0, d1 = o["round1"][0][0]
    for (e0, e1), _ in o["round1"][1:]:
        d0, d1 = mm.add_mod(d0, e0, p), mm.add_mod(d1, e1, p)
    o["round2"] = [step("relin_round2", mpc.relin_round2, ring, sk, eph, d0, d1,
                        key(seed + 30 + i))
                   for i, (sk, (_, eph)) in enumerate(zip(o["sks"], o["round1"]))]
    o["rk"] = step("relin_assemble", mpc.relin_assemble, ring, [s for s, _ in o["round1"]],
                   o["round2"])
    g = polyops.steps_to_galois_elt(1, n)
    o["a_g"] = step("relin_crs", mpc.relin_crs, ring, MPC_CRS + 2)
    o["galois_shares"] = [step("galois_share", mpc.galois_share, ring, sk, g, o["a_g"],
                               key(seed + 40 + i)) for i, sk in enumerate(o["sks"])]
    o["gk"] = ringkit.GaloisKey({g: step("galois_assemble", mpc.galois_assemble, ring, g,
                                         o["galois_shares"], o["a_g"])})
    r = np.random.default_rng(seed)
    o["m1"], o["m2"] = r.integers(0, t, n), r.integers(0, t, n)
    o["c1"] = step("encrypt", bfv.encrypt, ctx, o["pk"], bfv.encode(ctx, o["m1"]), key(seed + 50))
    o["c2"] = step("encrypt", bfv.encrypt, ctx, o["pk"], bfv.encode(ctx, o["m2"]), key(seed + 51))
    o["prod"] = step("mult_relin", lambda: bfv.relinearize(ctx, bfv.multiply(ctx, o["c1"], o["c2"]),
                                                           o["rk"]))
    o["rot"] = step("rotate_rows", bfv.rotate_rows, ctx, o["prod"], o["gk"], 1)
    half = n // 2
    w = o["m1"] * o["m2"] % t
    o["want"] = np.concatenate([np.roll(w[:half], -1), np.roll(w[half:], -1)])
    o["partials"] = [step("bfv_decrypt_partial", mpc.bfv_decrypt_partial, ctx, sk, o["rot"],
                          key(seed + 60 + i)) for i, sk in enumerate(o["sks"])]
    o["fused"] = step("bfv_decrypt_fuse", mpc.bfv_decrypt_fuse, ctx, o["rot"], o["partials"])
    o["boot"] = [step("bfv_colboot_participant", mpc.bfv_colboot_participant, ctx, sk, o["rot"],
                      MPC_CRS + 3, key(seed + 70 + i)) for i, sk in enumerate(o["sks"])]
    o["fresh"] = step("bfv_colboot_coordinator", mpc.bfv_colboot_coordinator, ctx, o["rot"],
                      o["boot"], MPC_CRS + 3)
    o["fresh_partials"] = [step("bfv_decrypt_partial", mpc.bfv_decrypt_partial, ctx, sk,
                                o["fresh"], key(seed + 80 + i)) for i, sk in enumerate(o["sks"])]
    o["fresh_fused"] = step("bfv_decrypt_fuse", mpc.bfv_decrypt_fuse, ctx, o["fresh"],
                            o["fresh_partials"])
    o["joint"] = joint_secret(ring, o["sks"])
    o["shamir"] = step("shamir_share_secret", mpc.shamir_share_secret, ctx, key(seed + 90),
                       o["joint"], 5, 3, threshold=3)
    o["t_partials"] = [step("bfv_decrypt_partial_threshold", mpc.bfv_decrypt_partial_threshold,
                            ctx, o["shamir"][i - 1], o["rot"], MPC_GROUP, key(seed + 100 + i))
                       for i in MPC_GROUP]
    o["t_fused"] = step("bfv_decrypt_fuse", mpc.bfv_decrypt_fuse, ctx, o["rot"], o["t_partials"])
    return o


def mpc_ckks_run(ctx, step, pt=None, seed=MPC_SEED + 1000):
    """Three parties on a CKKS context: their keys, the collective public and
    relin keys; encrypt -> multiply -> relinearize -> rescale; threshold
    decryption at level 1; collective bootstrapping to level 0 and threshold
    decryption; Shamir 2 of 3 over the joint key and decryption by
    MPC_CKKS_GROUP.  `pt`: the plaintext of z to encrypt (default: encoded on
    ctx's device).  Returns {name: value} of every result."""
    from heongpu_tpu_torch.models import ckks, mpc, ringkit
    from heongpu_tpu_torch.ops import modmath as mm
    from heongpu_tpu_torch.utils import rng
    key = lambda s: rng.new_key(s, ctx.device)
    ring, n = ckks._ring(ctx), ctx.n
    o = {"sks": [step("keygen_secret", ringkit.keygen_secret, ring, key(seed + i))
                 for i in range(MPC_PARTIES)]}
    o["a"] = step("crs_uniform", mpc.crs_uniform, ring, MPC_CRS + 4, (n,))
    o["pk_shares"] = [step("pk_share", mpc.pk_share, ring, sk, o["a"], key(seed + 10 + i))
                      for i, sk in enumerate(o["sks"])]
    o["pk"] = step("pk_assemble", mpc.pk_assemble, ring, o["pk_shares"], o["a"])
    o["a_d"] = step("relin_crs", mpc.relin_crs, ring, MPC_CRS + 5)
    o["round1"] = [step("relin_round1", mpc.relin_round1, ring, sk, o["a_d"], key(seed + 20 + i))
                   for i, sk in enumerate(o["sks"])]
    p = ring.base_qp.col()
    d0, d1 = o["round1"][0][0]
    for (e0, e1), _ in o["round1"][1:]:
        d0, d1 = mm.add_mod(d0, e0, p), mm.add_mod(d1, e1, p)
    o["round2"] = [step("relin_round2", mpc.relin_round2, ring, sk, eph, d0, d1,
                        key(seed + 30 + i))
                   for i, (sk, (_, eph)) in enumerate(zip(o["sks"], o["round1"]))]
    o["rk"] = step("relin_assemble", mpc.relin_assemble, ring, [s for s, _ in o["round1"]],
                   o["round2"])
    o["z"] = np.random.default_rng(seed).uniform(-1, 1, n // 2)
    o["want"] = o["z"] ** 2
    o["ct"] = step("encrypt", ckks.encrypt, ctx, o["pk"],
                   ckks.encode(ctx, o["z"]) if pt is None else pt, key(seed + 50))
    o["prod"] = step("mult_relin_rescale", lambda: ckks.rescale(ctx, ckks.relinearize(
        ctx, ckks.multiply(ctx, o["ct"], o["ct"]), o["rk"])))
    o["partials"] = [step("ckks_decrypt_partial", mpc.ckks_decrypt_partial, ctx, sk, o["prod"],
                          key(seed + 60 + i)) for i, sk in enumerate(o["sks"])]
    o["fused"] = step("ckks_decrypt_fuse", mpc.ckks_decrypt_fuse, ctx, o["prod"], o["partials"])
    o["boot"] = [step("ckks_colboot_participant", mpc.ckks_colboot_participant, ctx, sk,
                      o["prod"], MPC_CRS + 6, key(seed + 70 + i))
                 for i, sk in enumerate(o["sks"])]
    o["fresh"] = step("ckks_colboot_coordinator", mpc.ckks_colboot_coordinator, ctx, o["prod"],
                      o["boot"], MPC_CRS + 6)
    o["fresh_partials"] = [step("ckks_decrypt_partial", mpc.ckks_decrypt_partial, ctx, sk,
                                o["fresh"], key(seed + 80 + i)) for i, sk in enumerate(o["sks"])]
    o["fresh_fused"] = step("ckks_decrypt_fuse", mpc.ckks_decrypt_fuse, ctx, o["fresh"],
                            o["fresh_partials"])
    o["joint"] = joint_secret(ring, o["sks"])
    o["shamir"] = step("shamir_share_secret", mpc.shamir_share_secret, ctx, key(seed + 90),
                       o["joint"], 3, 2, threshold=2)
    o["t_partials"] = [step("ckks_decrypt_partial_threshold", mpc.ckks_decrypt_partial_threshold,
                            ctx, o["shamir"][i - 1], o["fresh"], MPC_CKKS_GROUP,
                            key(seed + 100 + i)) for i in MPC_CKKS_GROUP]
    o["t_fused"] = step("ckks_decrypt_fuse", mpc.ckks_decrypt_fuse, ctx, o["fresh"],
                        o["t_partials"])
    return o


def mpc_tensors(o, prefix):
    """{name: tensor} of every residue tensor in an MPC run's results."""
    import torch
    out = {}

    def walk(name, v):
        if isinstance(v, torch.Tensor):
            out[name] = v
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{name}[{i}]", x)
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(f"{name}[{k}]", x)
        elif hasattr(v, "keys") and not hasattr(v, "__dataclass_fields__"):
            walk(name, v.keys)
        elif hasattr(v, "__dataclass_fields__"):
            for k in v.__dataclass_fields__:
                walk(f"{name}.{k}", getattr(v, k))
    for k, v in o.items():
        walk(f"{prefix}{k}", v)
    return out


def mpc_draws(dev, step):
    """The new Threefry draws at (2^16,) shapes, for the card-against-CPU
    check: {name: tensor}."""
    from heongpu_tpu_torch.utils import nt, rng
    n = 1 << 16
    key = rng.new_key(MPC_SEED + 999, dev)
    primes = nt.generate_ntt_primes(29, 3, 4096)
    return {"randint": step("randint", rng.randint, key, (n,), -(1 << 30), 1 << 30, dev),
            "normal": step("normal", rng.normal, key, (n,), dev),
            "permutation": step("permutation", rng.permutation, key, n, dev),
            "gaussian_rns": step("gaussian_rns", rng.gaussian_rns, key, primes, (n,), dev),
            "ternary_hw": step("ternary_hw", rng.ternary_hw, key, n, n // 2, dev),
            "bits32_fold_in": step("bits32", rng.bits32, rng.fold_in(key, 5), (n,), dev)}


def mpc_small(dev, n, record):
    """Phase 18 (a)'s run on `dev`: both schemes' MPC runs at N=n and the
    (2^16,) draws, K7's launches held to mpc_k7_predicted on the card.
    Returns ({name: tensor}, the normal draw, {result: (decoded, wanted)})."""
    from heongpu_tpu_torch.models import bfv, ckks
    from heongpu_tpu_torch.utils import params
    t = params.plain_modulus_for(n, MPC_SMALL_T_BITS)
    step = mpc_stepper(n, record, check=card_device(dev))
    bctx = bfv.make_context(n, t, q_bits=MPC_SMALL_BFV_Q_BITS, device=dev)
    bo = mpc_bfv_run(bctx, step)
    cctx = ckks.make_context(n, MPC_SMALL_CKKS_Q_BITS, device=dev)
    # the plaintext from the CPU encoder on both sides: the float64 encoder may
    # round differently on the card
    z = np.random.default_rng(MPC_SEED + 1000).uniform(-1, 1, n // 2)
    pt = ckks.encode(ckks.make_context(n, MPC_SMALL_CKKS_Q_BITS, device="cpu"), z)
    co = mpc_ckks_run(cctx, step, pt=ckks.Plaintext(pt.m.to(dev), pt.level, pt.scale))
    out = mpc_tensors(bo, "bfv ")
    out.update(mpc_tensors(co, "ckks "))
    draws = mpc_draws(dev, mpc_stepper(1 << 16, record, check=card_device(dev)))
    normal = draws.pop("normal")
    out.update(draws)
    dec = {f"bfv {k}": (bfv.decode(bctx, bo[k]), bo["want"])
           for k in ("fused", "fresh_fused", "t_fused")}
    dec.update({f"ckks {k}": (ckks.decode(cctx, co[k]).real, co["want"])
                for k in ("fused", "fresh_fused", "t_fused")})
    return out, normal, dec


def mpc_check(what, dec, card):
    """Prints each decryption's exactness (BFV) or max error (CKKS) and
    raises unless BFV is exact and CKKS within MPC_TOL.  Returns the
    CKKS errors."""
    exact = {k: bool(np.array_equal(got, want)) for k, (got, want) in dec.items()
             if k.startswith("bfv")}
    errs_ = {k: float(np.abs(got - want).max()) for k, (got, want) in dec.items()
             if k.startswith("ckks")}
    print(f"{what}: BFV exact {exact}; CKKS max error {errs_} (limit {MPC_TOL}) [{card}]")
    if not all(exact.values()) or not all(e <= MPC_TOL for e in errs_.values()):
        raise AssertionError(f"MPC {what}: a threshold decryption is wrong: {exact} {errs_}")
    return errs_


def mpc_full(scheme, ctx, card, errs):
    """Phase 18 (b) or (c): the MPC run on a full-width context, launches
    counted from 0, every launch at a new shape held against plain, K6 once
    per ÷P site, no plain Threefry pass on the card, K7 per step as
    predicted; decryptions checked; the oracle joint key's noise budget
    (BFV); ms per protocol step (median of 3), device busy and idle share of
    a threshold decryption and of a collective bootstrap, the collective
    keys' bytes, K7's raw-words mode timed at the run's widest draw and at
    one row.  Returns (launches; record; K7's timings)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import bfv, ckks, mpc
    from heongpu_tpu_torch.utils import rng
    what = f"MPC {scheme.upper()} N={ctx.n}"
    run = mpc_bfv_run if scheme == "bfv" else mpc_ckks_run
    steps, calls = {}, {}
    kernels.reset_launches()
    t1 = time.perf_counter()
    with held_against_plain(what, errs), div_round_sites(what), plain_threefry_on_card(what):
        o = run(ctx, mpc_stepper(ctx.n, steps, calls=calls))
        if scheme == "bfv":
            dec = {f"bfv {k}": (bfv.decode(ctx, o[k]), o["want"])
                   for k in ("fused", "fresh_fused", "t_fused")}
            nb = (bfv.noise_budget(ctx, o["joint"], o["rot"]),
                  bfv.noise_budget(ctx, o["joint"], o["fresh"]))
        else:
            dec = {f"ckks {k}": (ckks.decode(ctx, o[k]).real, o["want"])
                   for k in ("fused", "fresh_fused", "t_fused")}
            nb = None
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
    run_s = time.perf_counter() - t1
    key_bytes = {"public": nbytes(o["pk"].pk0, o["pk"].pk1),
                 "relin": nbytes(o["rk"].k0, o["rk"].k1)}
    if scheme == "bfv":
        key_bytes["galois"] = sum(nbytes(k.k0, k.k1) for k in o["gk"].keys.values())
    print(f"{what}: {MPC_PARTIES} parties in {run_s:.1f} s, launches {launches}; K7 (uniform, "
          f"words) per step as predicted: " + ", ".join(
              f"{k} {(v.get('threefry_uniform', 0), v.get('threefry_bits', 0))}"
              for k, v in steps.items()) + f"; collective key bytes {key_bytes}")
    cerrs = mpc_check(what, dec, card)
    if nb is not None:
        print(f"{what}: noise budget under the joint key Σ s_i before / after the collective "
              f"bootstrap {nb[0]:.3f} / {nb[1]:.3f} bits [{card}]")
        if not nb[1] > nb[0]:
            raise AssertionError(f"{what}: the collective bootstrap left the budget at {nb}")
    require_launched(what, launches, ("ntt_fwd", "ntt_inv", "mac_keys", "div_round",
                                      "threefry_uniform", "threefry_bits"))
    if scheme == "ckks":      # the coordinator's exact CRT alone
        ct = o["prod"]
        calls["crt_relift"] = lambda: mpc.crt_relift(
            ct.c[0], ctx.q_primes[:ctx.active(ct.level)], ctx.q_primes)
    ms = {k: median_ms(fn, reps=3, warm=1) for k, fn in calls.items()}
    print(f"time {what}, ms per protocol step (median of 3): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + f" [{card}]")
    sks = o["sks"]
    key = rng.new_key(MPC_SEED + 4343, ctx.device)
    if scheme == "bfv":
        decrypt_all = lambda: mpc.bfv_decrypt_fuse(ctx, o["rot"], [
            mpc.bfv_decrypt_partial(ctx, sk, o["rot"], key) for sk in sks])
        boot_all = lambda: mpc.bfv_colboot_coordinator(ctx, o["rot"], [
            mpc.bfv_colboot_participant(ctx, sk, o["rot"], MPC_CRS + 3, key) for sk in sks],
            MPC_CRS + 3)
    else:
        decrypt_all = lambda: mpc.ckks_decrypt_fuse(ctx, o["prod"], [
            mpc.ckks_decrypt_partial(ctx, sk, o["prod"], key) for sk in sks])
        boot_all = lambda: mpc.ckks_colboot_coordinator(ctx, o["prod"], [
            mpc.ckks_colboot_participant(ctx, sk, o["prod"], MPC_CRS + 6, key) for sk in sks],
            MPC_CRS + 6)
    prof = {}
    print_profile(f"{what} threshold decryption (3 partials + fuse)", decrypt_all, 3, card, prof,
                  "threshold_decrypt")
    print_profile(f"{what} collective bootstrap (3 participants + coordinator)", boot_all, 3,
                  card, prof, "colboot")
    k = ctx.k
    kern = time_kernels({**threefry_bits_shapes((k, ctx.n), ctx.device, f"{scheme} ({k}, N)"),
                         **threefry_bits_shapes((ctx.n,), ctx.device, f"{scheme} (N,)")},
                        f"MPC {scheme.upper()}'s", ctx.n, card, errs)
    rec = {"launches": launches, "step_launches": steps, "key_bytes": key_bytes, "ms": ms,
           "max_err": cerrs, "noise_budget": nb, "profile": prof, "kernels": kern,
           "seconds": run_s}
    return launches, rec, kern


def mpc_phases(dev, card, errs, n_small=256, n_bfv=BFV_N, n_ckks=N):
    """Phase 18: MPC, three parties, every key, share and mask from Threefry
    keys.  (a) n_small: every MPC entry point of both schemes (BFV on
    tests/test_mpc.py's [29]*3 chain, CKKS on its [29, 25, 25, 25], t-of-N 3
    of 5 and 2 of 3) and the new draws at (2^16,) shapes on the card, against
    the CPU plain path: identical residues, normal within 1e-6, decryptions
    exact / within MPC_TOL; (b) BFV on phase 15's default chain at n_bfv;
    (c) CKKS Method I on phase 16's shape at n_ckks (mpc_full).  Launches
    counted from 0 in each, K7's per step as mpc_k7_predicted says, no plain
    Threefry pass on the card, K6 once per ÷P site.  Returns (the launches of
    (a)-(c), summed; record; K7's raw-words timings)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import bfv, ckks
    from heongpu_tpu_torch.utils import params
    rec = {}

    # -- 18. (a) card against CPU at n_small ---------------------------------------------
    t0 = time.perf_counter()
    cpu_out, cpu_normal, cpu_dec = mpc_small("cpu", n_small, {})
    steps_a = {}
    kernels.reset_launches()
    what = f"MPC N={n_small}"
    with held_against_plain(what, errs), div_round_sites(what), plain_threefry_on_card(what):
        out, normal, dec = mpc_small(dev, n_small, steps_a)
        torch.cuda.synchronize()
        launches_a = dict(kernels.launches)
    diff = [k for k in out if not torch.equal(out[k].cpu(), cpu_out[k])]
    normal = normal.cpu()
    normal_err = float((normal - cpu_normal).abs().max())
    normal_same = int((normal == cpu_normal).sum())
    print(f"MPC (a) N={n_small}: {len(out)} residue tensors of every MPC entry point (BFV and "
          f"CKKS, 3 parties, 3 of 5 and 2 of 3) and the (2^16,) draws on the card identical to "
          f"the CPU plain path's: {not diff} {diff[:8] or ''}; normal (2^16,) max |card - CPU| "
          f"{normal_err:.3e}, {normal_same} of {normal.numel()} words equal; launches "
          f"{launches_a}; {time.perf_counter() - t0:.1f} s")
    mpc_check(f"MPC (a) N={n_small} card", dec, card)
    mpc_check(f"MPC (a) N={n_small} CPU", cpu_dec, card)
    if diff or normal_err > 1e-6:
        raise AssertionError(f"MPC (a): card and CPU differ: {diff[:8]}, normal {normal_err}")
    require_launched(what, launches_a, ("threefry_uniform", "threefry_bits"))
    rec[f"n{n_small}"] = {"identical_to_cpu": True, "tensors": len(out),
                          "normal_max_abs_diff": normal_err, "normal_equal_words": normal_same,
                          "launches": launches_a, "step_launches": steps_a,
                          "seconds": time.perf_counter() - t0}

    # -- 18. (b) BFV at n_bfv on phase 15's default chain ---------------------------------
    ctx = bfv.make_context(n_bfv, params.plain_modulus_for(n_bfv, BFV_T_BITS), device=dev)
    launches_b, rec["bfv"], kern_b = mpc_full("bfv", ctx, card, errs)
    del ctx
    # -- 18. (c) CKKS Method I at n_ckks on phase 16's shape ---------------------------------
    ctx = ckks.make_context(n_ckks, Q_BITS, device=dev)
    launches_c, rec["ckks"], kern_c = mpc_full("ckks", ctx, card, errs)
    del ctx
    torch.cuda.empty_cache()
    launches = {k: launches_a[k] + launches_b[k] + launches_c[k] for k in launches_a}
    return launches, rec, {**kern_b, **kern_c}


# The parallel layer (phase 19): the sharded NTT on K1's split passes and the
# digit-sharded keyswitch at the main path's width, and limb_align at phase 11's N=256
PAR_DS = (2, 4, 8)      # ranks of the in-process split transforms of (a)
PAR_MAIN_PASS = "ntt_pass fwd1 D=2"   # the kernel record's shape of K1's split entry
PAR_ALIGN = 4


def split_transform(x, tb, inverse, d):
    """K1's split passes on every rank's block of x (..., L, N), the exchange done
    in process (chunk r of each rank's pass-1 output to rank r, the all-to-all's
    layout): the whole transform, (..., L, N)."""
    import torch
    from heongpu_tpu_torch.ops import ntt as nttm
    a, b = (tb.n2, tb.n1) if inverse else (tb.n1, tb.n2)
    blocks = x.view(x.shape[:-1] + (a, b))
    w = b // d
    sends = [nttm.ntt_pass_cuda(blocks[..., r * w:(r + 1) * w].contiguous(), tb, inverse, 1, d, r)
             for r in range(d)]
    outs = [nttm.ntt_pass_cuda(torch.stack([s[r] for s in sends]), tb, inverse, 2, d, r)
            for r in range(d)]
    return torch.cat(outs, dim=-1).reshape(x.shape)


def pass_bound(x, tb, inverse, pass_, d):
    """One split pass's bound on its input x: x and the output once, and pass 1's
    block of the cross twiddles with its Shoup companions and the stage table
    (pass 2 its stage table); the butterflies of its column transforms, and
    pass 1's cross-twiddle products."""
    rows = x.numel() // (tb.n // d)
    s = tb.n1 if (pass_ == 1) != inverse else tb.n2
    tabs = ntt_tables(tb, inverse)
    tab_bytes = (nbytes(*tabs[:2]) // d if pass_ == 1 else 0) + nbytes(
        *(tabs[2:4] if (pass_ == 1) != inverse else tabs[4:]))
    ops = rows * (tb.n // d) // 2 * (s.bit_length() - 1) * BUTTERFLY_OPS
    if pass_ == 1:
        ops += rows * (tb.n // d) * SHOUP_OPS
    return bound(2 * nbytes(x) + tab_bytes + nbytes(tb.p), ops)


def ntt_shapes(tb, polys, inverse, gen, dev) -> dict:
    """time_kernels' entry for K1 whole (one direction) on random residues
    (polys, limbs, N) over tb."""
    from heongpu_tpu_torch.ops import ntt as nttm
    x = rand_residues(list(tb.primes) * polys, (polys * tb.num_limbs, tb.n), gen, dev)
    x = x.view(polys, tb.num_limbs, tb.n)
    what = f"({polys}, {tb.num_limbs}, 2^{tb.logn})"
    plain = nttm.ntt_inv_plain if inverse else nttm.ntt_fwd_plain
    return {f"{'ntt_inv' if inverse else 'ntt_fwd'} {what}": (
        lambda: nttm.ntt_cuda(x, tb, inverse), lambda: plain(x, tb), what,
        bound(2 * nbytes(x) + nbytes(tb.p, *ntt_tables(tb, inverse)),
              transform_ops(polys * tb.num_limbs, tb.n)))}


def split_pass_shapes(tb, x, y, ds=PAR_DS) -> dict:
    """time_kernels' entries for each pass of K1's split entry at D ranks in
    ds, on rank 0's block: of x (L, N) for the forward, of its transform y
    for the inverse; pass 2 takes D copies of pass 1's first chunk, an
    exchange buffer's shape."""
    import torch
    from heongpu_tpu_torch.ops import ntt as nttm
    shapes = {}
    for d in ds:
        for inverse, src in ((False, x), (True, y)):
            a, b = (tb.n2, tb.n1) if inverse else (tb.n1, tb.n2)
            blk = src.view(tb.num_limbs, a, b)[..., : b // d].contiguous()
            recv = torch.stack([nttm.ntt_pass_cuda(blk, tb, inverse, 1, d, 0)[0]] * d)
            name = "inv" if inverse else "fwd"
            for pass_, arg in ((1, blk), (2, recv)):
                shapes[f"ntt_pass {name}{pass_} D={d}"] = (
                    lambda arg=arg, inverse=inverse, pass_=pass_, d=d:
                        nttm.ntt_pass_cuda(arg, tb, inverse, pass_, d, 0),
                    lambda arg=arg, inverse=inverse, pass_=pass_, d=d:
                        nttm.ntt_pass_plain(arg, tb, inverse, pass_, d, 0),
                    f"{tuple(arg.shape)}", pass_bound(arg, tb, inverse, pass_, d))
    return shapes


def split_transform_ms(tb, x, y, card, ds=PAR_DS, label="") -> dict:
    """Device ms (traced_device_ms) of K1 whole at (L, N) (x forward, y
    inverse) and of the split transform over D ranks in one process for D in
    ds, each split result held equal to K1 whole first."""
    from heongpu_tpu_torch.ops import ntt as nttm
    out = {}
    for inverse, src, want in ((False, x, y), (True, y, x)):
        name = "inv" if inverse else "fwd"
        ms, _, traced, made = traced_device_ms(lambda: nttm.ntt_cuda(src, tb, inverse))
        out[f"whole {name}"] = ms
        for d in ds:
            if not split_transform(src, tb, inverse, d).equal(want):
                raise AssertionError(f"split transform {name} D={d} differs from K1 whole")
            sms, _, st, sm = traced_device_ms(lambda: split_transform(src, tb, inverse, d))
            out[f"split {name} D={d}"] = sms
            print(f"time split transform {'inverse' if inverse else 'forward'} "
                  f"({tb.num_limbs}, 2^{tb.logn}) over D={d} (2·D launches, in process){label}: "
                  f"device {fmt_ms(sms)} ms{dropped_note(st, sm)} against K1 whole {fmt_ms(ms)} "
                  f"ms{dropped_note(traced, made)} [{card}]")
    return out


def one_rank_group():
    """A one-rank NCCL process group on a free port of 127.0.0.1 and its 1 x 1
    ('dp', 'limb') mesh."""
    import socket
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.parallel import multihost
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    multihost.init_process(f"127.0.0.1:{port}", 0, 1)
    return meshlib.make_mesh(1)


def parallel_phases(dev, card, errs, gen, ctx, rk):
    """Phase 19: the parallel layer at the main path's width (N=2^16, twelve
    29-bit Q primes, alpha 4, four special primes: ctx and its relin key rk).
    (a) K1's split passes at D = 2, 4, 8 on 12 and 16 rows, every rank's block
    with the exchange done in process, equal to K1 whole bit for bit, each launch
    held against plain; device ms of a split transform against K1 whole, and of
    each pass (the kernel record).  (b) A one-rank NCCL group (the box has one
    card: no exchange runs on the card here; the gloo tests hold it on the CPU):
    make_sharded_ntt on a one-rank 'coef' mesh equal to ntt_fwd / ntt_inv and
    keyswitch2_sharded on make_mesh(1) equal to the single-device keyswitch2 (K5), launches counted from 0 (ntt_pass,
    base_conv, mac_keys and div_round must launch, keyswitch2_fused must not);
    the sharded keyswitch's device ms against K5's.  (c) limb_align=4 keys at
    phase 11's N=256 configuration: every key's limb extent divides 4, and the
    card's bootstrap equals the CPU's.  Returns (the launches of (b), record,
    the split passes' timings)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks, ckks_boot
    from heongpu_tpu_torch.ops import keyswitch2 as ks2m
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.parallel import keyswitch_sharded as kss
    from heongpu_tpu_torch.parallel import ntt_sharded as ns
    rec = {}

    # -- 19. (a) K1's split passes against K1 whole ----------------------------------------
    t0 = time.perf_counter()
    tq = ctx.ntt_q(0)
    same_a = {}
    with held_against_plain("parallel (a) split passes", errs):
        for tb in (tq, ctx.ntt_qp):
            x = rand_residues(list(tb.primes), (tb.num_limbs, N), gen, dev)
            whole = nttm.ntt_cuda(x, tb, False)
            back = nttm.ntt_cuda(whole, tb, True)
            for d in PAR_DS:
                f, i = split_transform(x, tb, False, d), split_transform(whole, tb, True, d)
                same_a[f"{tb.num_limbs} rows D={d}"] = (torch.equal(f, whole)
                                                        and torch.equal(i, back)
                                                        and torch.equal(i, x))
        torch.cuda.synchronize()
    print(f"parallel (a) K1 split passes at D={PAR_DS} against K1 whole, 12 and 16 rows of "
          f"2^16: {same_a}; {time.perf_counter() - t0:.1f} s")
    if not all(same_a.values()):
        raise AssertionError(f"parallel (a): K1's split passes differ from K1 whole: {same_a}")
    x = rand_residues(list(tq.primes), (tq.num_limbs, N), gen, dev)
    y = nttm.ntt_cuda(x, tq, False)
    rec["split_transform_device_ms"] = split_transform_ms(tq, x, y, card)
    pass_rec = time_kernels(split_pass_shapes(tq, x, y), "the parallel phase's", N, card, errs)

    # -- 19. (b) a one-rank NCCL group -----------------------------------------------------
    t0 = time.perf_counter()
    mesh = one_rank_group()
    try:
        fwd, inv = ns.make_sharded_ntt(
            DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("coef",)), tq)
        ks2 = ctx.ks2[0]
        sc = kss.stack_convs(ks2)
        poly = rand_residues(list(ctx.q_primes), (len(ctx.q_primes), N), gen, dev)
        args = (ks2, sc, ctx.ntt_qp_at(0), ctx.base_qp_at(0), tq)
        kernels.reset_launches()
        what = "parallel (b) one-rank NCCL group"
        with held_against_plain(what, errs), div_round_sites(what):
            y4 = fwd(ns.to_four_step(x, tq))
            x4 = inv(y4)
            s0, s1 = kss.keyswitch2_sharded(mesh, poly, rk.k0, rk.k1, *args)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
        r0, r1 = ks2m.keyswitch2(poly, rk.k0, rk.k1, ks2, ctx.ntt_qp_at(0), ctx.base_qp_at(0),
                                 False, True, tq)
        same_b = {"ntt_fwd": torch.equal(ns.from_four_step_ntt(y4), y),
                  "ntt_inv": torch.equal(x4, ns.to_four_step(x, tq)),
                  "keyswitch": torch.equal(s0, r0) and torch.equal(s1, r1)}
        print(f"{what}: sharded NTT (12, 2^16) and keyswitch (bench shape: 12 Q limbs, 3 digits, "
              f"16-limb Q~) equal to ntt_fwd / ntt_inv and to keyswitch2 (K5): {same_b}; "
              f"launches {launches}; {time.perf_counter() - t0:.1f} s")
        if not all(same_b.values()):
            raise AssertionError(f"parallel (b): the sharded layer differs: {same_b}")
        require_launched(what, launches, ("ntt_pass", "base_conv", "mac_keys", "div_round"))
        if launches["keyswitch2_fused"]:
            raise AssertionError(f"parallel (b): the sharded keyswitch launched K5: {launches}")
        ks_ms, _, ks_tr, ks_made = traced_device_ms(
            lambda: kss.keyswitch2_sharded(mesh, poly, rk.k0, rk.k1, *args))
        k5_ms, _, k5_tr, k5_made = traced_device_ms(
            lambda: ks2m.keyswitch2(poly, rk.k0, rk.k1, ks2, ctx.ntt_qp_at(0), ctx.base_qp_at(0),
                                    False, True, tq))
        print(f"time keyswitch2_sharded on one rank at the bench shape: device {fmt_ms(ks_ms)} ms"
              f"{dropped_note(ks_tr, ks_made)} against keyswitch2 through K5 {fmt_ms(k5_ms)} ms"
              f"{dropped_note(k5_tr, k5_made)} [{card}]")
    finally:
        dist.destroy_process_group()
    rec["one_rank"] = {"identical": same_b, "launches": launches,
                       "keyswitch_sharded_device_ms": ks_ms, "keyswitch_k5_device_ms": k5_ms}

    # -- 19. (c) limb_align=4 at phase 11's N=256 ------------------------------------------
    t0 = time.perf_counter()
    cctx, csk, ckeys, cct, z, _ = boot_setup(256, PREC_Q_BITS, PREC_CTX, PREC_CFG, 16, 21, dev,
                                             key_dev="cpu", limb_align=PAR_ALIGN)
    ext = sorted({k.k0.shape[1] for k in ckeys.gk.keys.values()} | {ckeys.rk.k0.shape[1]})
    cpu_out = ckks_boot.regular_bootstrap(cctx, cct, ckeys)
    dctx = ckks.make_context(256, PREC_Q_BITS, device=dev, **PREC_CTX)
    what = f"bootstrap N=256 limb_align={PAR_ALIGN}"
    with held_against_plain(what, errs), div_round_sites(what):
        out = ckks_boot.regular_bootstrap(
            dctx, ckks.Ciphertext(cct.c.to(dev), cct.size, cct.level, cct.scale),
            boot_keys_to(ckeys, dev))
        torch.cuda.synchronize()
    same_c = torch.equal(out.c.cpu(), cpu_out.c) and out.level == cpu_out.level
    err_c, _ = boot_error(cctx, csk, cpu_out, z)
    print(f"parallel (c) {what}: {len(ckeys.gk.keys)} Galois keys and the relin key at limb "
          f"extents {ext}; card residues identical to the CPU plain path's: {same_c}; max error "
          f"{err_c:.3e} (limit {TOL_BOOT_PRECISE}); {time.perf_counter() - t0:.1f} s")
    if any(e % PAR_ALIGN for e in ext) or not same_c or not err_c < TOL_BOOT_PRECISE:
        raise AssertionError("parallel (c): a key extent 4 does not divide, card and CPU differ, "
                             "or the error is above the limit")
    rec["limb_align"] = {"extents": ext, "identical_to_cpu": same_c, "max_abs_err": err_c}
    return launches, rec, pass_rec


# The host utilities, the native parameter engine and the limb-sharded CKKS step
# (phase 20): the utilities on the main path's relinearization key, the engine at
# the main path's N, the sharded step on a one-rank NCCL group at the main path's
# width under Method II and on phase 16's Method-I shape, a batch of SHARDED_BATCH
SHARDED_BATCH = 2
SHARDED_OPS = ("mult0", "relin0", "rescale", "mult1", "relin1")


def utilities_phase(card, ctx, rk, ct1, ct2):
    """Phase 20 (a): the main path's relin key parked by storage.to_host and
    brought back by to_device (storage_of DEVICE, HOST, DEVICE), mult+relin on
    it equal to mult+relin on the key that never moved; device_pool_status's
    bytes in use against torch.cuda.memory_allocated; time_op of mult+relin;
    profiling.trace of one mult+relin, its file holding the K5 launch; a
    device_memory_profile snapshot.  Returns the record."""
    import pickle
    import tempfile
    import torch
    from heongpu_tpu_torch.kernels import build
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.utils import memory, profiling, storage
    t0 = time.perf_counter()
    step = lambda key: ckks.relinearize(ctx, ckks.multiply(ctx, ct1, ct2), key)
    want = step(rk).c
    parked = storage.to_host(rk)
    back = storage.to_device(parked)
    where = [storage.storage_of(t) for t in (rk, parked, back)]
    same = torch.equal(step(back).c, want)
    del parked, back
    torch.cuda.synchronize()
    st = memory.device_pool_status()
    allocated = torch.cuda.memory_allocated()
    secs = profiling.time_op(step, rk, iters=5)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        with profiling.trace(tmp):
            step(rk)
        names = os.listdir(tmp)
        k5_traced = any("keyswitch2_fused_kernel" in open(os.path.join(tmp, f)).read()
                        for f in names)
        snap = os.path.join(tmp, "snapshot.pickle")
        profiling.device_memory_profile(snap)
        with open(snap, "rb") as f:
            segments = len(pickle.load(f)["segments"])
        snap_bytes = os.path.getsize(snap)
    ok = {"storage_of": where == [storage.DEVICE, storage.HOST, storage.DEVICE],
          "mult_relin_on_moved_key": same, "bytes_in_use": st.bytes_in_use == allocated,
          "time_op": secs > 0, "trace_holds_k5": len(names) == 1 and k5_traced,
          "memory_snapshot": segments > 0}
    print(f"utilities (a): storage_of relin key / to_host / to_device {where}; mult+relin on the "
          f"moved key identical: {same}; {st}; bytes in use {st.bytes_in_use} against "
          f"memory_allocated {allocated}; time_op mult+relin {secs * 1e3:.4f} ms; trace {names} "
          f"holds K5: {k5_traced}; snapshot {segments} segments, {snap_bytes} bytes; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    if not all(ok.values()):
        raise AssertionError(f"utilities (a) failed: {ok}")
    return {"checks": ok, "time_op_ms": secs * 1e3, "bytes_in_use": st.bytes_in_use,
            "bytes_limit": st.bytes_limit, "snapshot_segments": segments}


def native_phase(card):
    """Phase 20 (b): the native parameter engine, built with g++, must be
    available; the main path's chain (twelve 29-bit Q primes, then four 30-bit
    specials, as make_context draws them) and the NTT tables over it at N=2^16
    equal on the engine and on the pure-Python path.  Returns the record."""
    import torch
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.utils import native, nt
    if not native.available():
        raise AssertionError(f"native (b): the parameter engine did not build: "
                             f"{native.unavailable_reason()}")

    def chain():
        t = time.perf_counter()
        used, primes = set(), []
        for b in Q_BITS:
            primes += nt.generate_ntt_primes(b, 1, N, exclude=used)
            used.add(primes[-1])
        primes += nt.generate_ntt_primes(30, ALPHA, N, exclude=used)
        roots = [nt.minimal_primitive_root_2n(2 * N, p) for p in primes]
        tb = nttm.build_ntt_tables(primes, N, device="cpu")
        return primes, roots, tb, time.perf_counter() - t

    got = chain()
    saved = native.available
    native.available = lambda: False
    try:
        py = chain()
    finally:
        native.available = saved
    same = {"primes": got[0] == py[0], "roots": got[1] == py[1],
            "tables": all(torch.equal(getattr(got[2], f), getattr(py[2], f))
                          for f in got[2]._tensor_fields())}
    print(f"native (b): engine built with g++; {len(got[0])} primes, roots and NTT tables at "
          f"N={N} equal to the pure-Python path's: {same}; {got[3]:.2f} s against {py[3]:.2f} s "
          f"in Python (host) [{card}]")
    if not all(same.values()):
        raise AssertionError(f"native (b): the engine and the Python path differ: {same}")
    return {"identical": same, "engine_s": got[3], "python_s": py[3]}


def sharded_step(mod, ctx, rk, c1, c2):
    """multiply -> relinearize -> rescale -> multiply (the square) ->
    relinearize through `mod` (ckks or parallel.ckks_sharded): every op's c."""
    from heongpu_tpu_torch.models import ckks
    a = ckks.Ciphertext(c1, 2, 0, ctx.default_scale)
    b = ckks.Ciphertext(c2, 2, 0, ctx.default_scale)
    out = {"mult0": mod.multiply(ctx, a, b)}
    out["relin0"] = mod.relinearize(ctx, out["mult0"], rk)
    out["rescale"] = mod.rescale(ctx, out["relin0"])
    out["mult1"] = mod.multiply(ctx, out["rescale"], out["rescale"])
    out["relin1"] = mod.relinearize(ctx, out["mult1"], rk)
    return {k: v.c for k, v in out.items()}


def ckks_sharded_phase(dev, card, errs, gen, ctx, rk, ct1, ct2):
    """Phase 20 (c): the limb-sharded CKKS step (parallel/ckks_sharded.py) on a
    one-rank NCCL group (the box has one card: no exchange runs on it; the gloo
    tests hold the exchanges on the CPU), at the main path's width under Method
    II (ctx, rk and the pair ct1, ct2 of phase 5) and on phase 16's Method-I
    shape, each on a batch of SHARDED_BATCH pairs placed by ct_sharding(batched)
    with the key placed by shard_pytree_limb_axis: multiply -> relinearize ->
    rescale -> multiply -> relinearize, launches counted from 0 and every launch
    held against plain, K5 never launched and K6 once a relinearize; every op's
    result equal to the unsharded entry points' on each pair.  Then the device
    busy ms of one mult+relin+rescale, sharded on one rank against unsharded.
    Returns (launches, record)."""
    import torch
    import torch.distributed as dist
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.parallel import ckks_sharded as cks
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.utils import rng
    t0 = time.perf_counter()
    m1ctx = ckks.make_context(N, Q_BITS, device=dev)
    rk1 = ckks.keygen_relin(m1ctx, rng.new_generator(201, dev),
                            ckks.keygen_secret(m1ctx, rng.new_generator(200, dev)))
    q1 = list(m1ctx.q_primes) * 2 * SHARDED_BATCH
    pairs = {"Method II": (ctx, rk, torch.stack([ct1.c, ct2.c]), torch.stack([ct2.c, ct1.c])),
             "Method I": (m1ctx, rk1,
                          *(rand_residues(q1, (len(q1), N), gen, dev).view(
                              SHARDED_BATCH, 2, m1ctx.k, N) for _ in range(2)))}
    mesh = one_rank_group()
    try:
        place = meshlib.ct_sharding(mesh, batched=True).place
        placed = {k: (cx, meshlib.shard_pytree_limb_axis(key, mesh), place(a), place(b))
                  for k, (cx, key, a, b) in pairs.items()}
        what = "ckks_sharded (c) one-rank NCCL group"
        kernels.reset_launches()
        with held_against_plain(what, errs), div_round_sites(what) as sites:
            outs = {k: sharded_step(cks, *v) for k, v in placed.items()}
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
        same = {}
        for k, (cx, key, a, b) in pairs.items():
            refs = [sharded_step(ckks, cx, key, a[i], b[i]) for i in range(SHARDED_BATCH)]
            same[k] = all(torch.equal(outs[k][op].to_local()[i], refs[i][op])
                          for op in SHARDED_OPS for i in range(SHARDED_BATCH))
        print(f"{what}: N={N}, {len(Q_BITS)} x 29-bit Q, Method II (alpha {ALPHA}) and Method I, "
              f"a batch of {SHARDED_BATCH}: mult -> relin -> rescale -> mult -> relin equal to "
              f"the unsharded entry points on each pair: {same}; launches {launches}; ÷P sites "
              f"{sites}; {time.perf_counter() - t0:.1f} s")
        if not all(same.values()):
            raise AssertionError(f"ckks_sharded (c): the sharded step differs: {same}")
        require_launched(what, launches, ("ntt_fwd", "ntt_inv", "base_conv", "mac_keys",
                                          "div_round"))
        relins = 2 * len(pairs)
        if launches["keyswitch2_fused"] or launches["div_round"] != relins:
            raise AssertionError(f"ckks_sharded (c): K5 launched or K6 not once a relinearize "
                                 f"({relins}): {launches}")
        timed = {}
        one = meshlib.ct_sharding(mesh).place
        for k, (cx, key, a, b) in placed.items():
            sa, sb = (ckks.Ciphertext(one(x.to_local()[0]), 2, 0, cx.default_scale) for x in (a, b))
            ua, ub = (ckks.Ciphertext(x[0], 2, 0, cx.default_scale) for x in pairs[k][2:])
            for name, mod, x, y, kk in (("sharded", cks, sa, sb, key),
                                        ("unsharded", ckks, ua, ub, pairs[k][1])):
                def fn(mod=mod, x=x, y=y, kk=kk, cx=cx):
                    return mod.rescale(cx, mod.relinearize(cx, mod.multiply(cx, x, y), kk))
                busy, wall, idle, per_kernel = device_idle_share(fn, 5)
                timed[f"{k} {name}"] = {"busy_ms": busy, "wall_ms": wall, "idle_share": idle,
                                        "kernel_ms": own_kernels(per_kernel)}
            print(f"time {k} mult+relin+rescale at N={N}, device busy / wall ms: sharded on one "
                  f"rank {fmt_ms(timed[f'{k} sharded']['busy_ms'])} / "
                  f"{timed[f'{k} sharded']['wall_ms']:.4f}, unsharded "
                  f"{fmt_ms(timed[f'{k} unsharded']['busy_ms'])} / "
                  f"{timed[f'{k} unsharded']['wall_ms']:.4f} [{card}]")
    finally:
        dist.destroy_process_group()
    rec = {"identical": same, "launches": launches, "sites": dict(sites), "timed": timed,
           "seconds": time.perf_counter() - t0}
    del m1ctx, rk1, pairs, placed, outs
    torch.cuda.empty_cache()
    return launches, rec


# The limb-sharded bootstrap (phase 21): (a) tests/test_boot_sharded.py's
# configuration at N=256 (sixteen 29-bit primes, Method II with alpha 2 and four
# special primes, Taylor degree 3, one squaring, 2 + 2 pieces, keys with
# limb_align=4), card against CPU; (b) phase 13 (c)'s depth-48 bootstrap at the
# main path's N, its keys and input made again from the same seed.
SH_Q_BITS = [29] * 16
SH_CTX = dict(scale_bits=28, ks_type="II", alpha=2, p_count=4)
SH_CFG = dict(taylor_degree=3, exp_squarings=1, ctos_pieces=2, stoc_pieces=2)


def boot_sharded_phase(dev, card, errs, boot_c, boot_rec):
    """Phase 21: the limb-sharded bootstrap (parallel/boot_sharded.py) on a
    one-rank NCCL group (the box has one card: no exchange runs on the card;
    the gloo tests hold the exchanges on the CPU), the keys placed by
    shard_pytree_limb_axis and the input by shard_array_limb_axis.  (a) N=256:
    the card's sharded coeff_to_slot and regular_bootstrap equal to the CPU
    plain path's unsharded results.  (b) Depth 48 at N: the sharded
    regular_bootstrap on phase 13 (c)'s keys and input (made again from its
    seed), launches counted from 0, every launch held against plain, K5 never
    launched, one K6 launch a ÷P site; its residues equal to phase 13 (c)'s
    output (boot_c), its error under TOL_BOOT_PRECISE; the placement's added
    bytes, the peak memory_allocated against phase 13 (c)'s, device busy, wall
    and idle share of one sharded bootstrap against one unsharded.  (c) The
    N=256 set of (a) is a compressed one (compress_keys=True) that (a) runs
    expanded: the sharded regular_bootstrap on the same keys stripped equals
    (a)'s residues, K7 once a stripped-key use; misuse: a plain-tensor
    ciphertext raises TypeError, keys stripped with no seed ParameterError.
    Returns (launches of (b), record)."""
    import torch
    import torch.distributed as dist
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks, ckks_boot
    from heongpu_tpu_torch.parallel import boot_sharded as bs
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.utils import errors
    rec = {}
    mesh = one_rank_group()
    try:
        place = lambda ct: ckks.Ciphertext(meshlib.shard_array_limb_axis(ct.c, mesh), ct.size,
                                           ct.level, ct.scale)
        # -- 21. (a) N=256, card against CPU ---------------------------------------------
        t0 = time.perf_counter()
        cctx, _, skeys_c, cct, _, _ = boot_setup(256, SH_Q_BITS, SH_CTX, SH_CFG, 16, 24, dev,
                                                 key_dev="cpu", limb_align=PAR_ALIGN,
                                                 compress=True)
        ckeys = expanded_keys(cctx, skeys_c)   # (a) runs the compressed set's keys whole
        raised = ckks_boot.mod_raise(cctx, cct, 1)
        cpu = ckks_boot.coeff_to_slot(cctx, raised, ckeys) + (
            ckks_boot.regular_bootstrap(cctx, cct, ckeys),)
        dctx = ckks.make_context(256, SH_Q_BITS, device=dev, **SH_CTX)
        dkeys = meshlib.shard_pytree_limb_axis(boot_keys_to(ckeys, dev), mesh)
        dct = place(ckks.Ciphertext(cct.c.to(dev), cct.size, cct.level, cct.scale))
        what = "boot_sharded (a) N=256 one-rank NCCL group"
        kernels.reset_launches()
        with held_against_plain(what, errs), div_round_sites(what):
            got = bs.coeff_to_slot(dctx, bs.mod_raise(dctx, dct, 1), dkeys) + (
                bs.regular_bootstrap(dctx, dct, dkeys),)
            torch.cuda.synchronize()
            launches_a = dict(kernels.launches)
        same_a = [torch.equal(g.c.to_local().cpu(), w.c) and g.level == w.level
                  for g, w in zip(got, cpu)]
        print(f"{what}: {SH_CFG}, limb_align={PAR_ALIGN}: sharded t0, t1 and bootstrap "
              f"identical to the CPU plain path's unsharded results: {same_a}; launches "
              f"{launches_a}; {time.perf_counter() - t0:.1f} s")
        if not all(same_a) or launches_a["keyswitch2_fused"]:
            raise AssertionError(f"boot_sharded (a): card and CPU differ, or K5 launched")
        rec["n256"] = {"identical_to_cpu": same_a, "launches": launches_a}

        # -- 21. (c) the same keys stripped; misuse ----------------------------------------
        what = "boot_sharded (c) N=256 stripped keys one-rank NCCL group"
        sdkeys = meshlib.shard_pytree_limb_axis(boot_keys_to(skeys_c, dev), mesh)
        with stripped_key_draws() as uses:
            kernels.reset_launches()
            with held_against_plain(what, errs), div_round_sites(what):
                got_c = bs.regular_bootstrap(dctx, dct, sdkeys)
                torch.cuda.synchronize()
                launches_c = dict(kernels.launches)
        predicted = stripped_key_uses(skeys_c)
        same_c = torch.equal(got_c.c.to_local(), got[-1].c.to_local()) and \
            got_c.level == got[-1].level
        k7 = launches_c["threefry_uniform"]
        print(f"{what}: residues identical to (a)'s on the keys whole: {same_c}; K7 launched "
              f"{k7} times for {uses[0]} stripped-key uses (predicted {predicted}); launches "
              f"{launches_c}")
        if not same_c or not k7 == uses[0] == predicted or launches_c["keyswitch2_fused"]:
            raise AssertionError(f"boot_sharded (c): stripped keys gave other residues, K7 "
                                 f"launched {k7} times for {uses[0]} uses ({predicted} "
                                 f"predicted), or K5 launched")
        misuse = {}
        try:
            bs.regular_bootstrap(dctx, ckks.Ciphertext(dct.c.to_local(), 2, dct.level,
                                                       dct.scale), dkeys)
        except TypeError as e:
            misuse["plain_tensor"] = type(e).__name__
        try:
            bs.regular_bootstrap(dctx, dct, stripped_without_seed(dkeys))
        except errors.ParameterError as e:
            misuse["stripped_key_without_seed"] = type(e).__name__
        print(f"boot_sharded (c) misuse: {misuse}")
        if set(misuse) != {"plain_tensor", "stripped_key_without_seed"}:
            raise AssertionError(f"boot_sharded (c): a misuse did not raise: {misuse}")
        rec["stripped"] = {"identical_to_a": same_c, "launches": launches_c,
                           "stripped_key_uses": uses[0], "predicted_uses": predicted}
        rec["misuse"] = misuse
        del cctx, ckeys, skeys_c, sdkeys, cct, raised, cpu, dctx, dkeys, dct, got, got_c

        # -- 21. (b) depth 48 at N, phase 13 (c)'s keys and input ----------------------------
        t0 = time.perf_counter()
        ctx, sk, keys, ct, z, keygen_s = boot_setup(N, BOOT_Q_BITS, BOOT_CTX, BOOT_CFG, BOOT_HW,
                                                    23, dev)
        torch.cuda.synchronize()
        remade_s = time.perf_counter() - t0
        mem0 = torch.cuda.memory_allocated(dev)
        skeys, sct = meshlib.shard_pytree_limb_axis(keys, mesh), place(ct)
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated(dev) - mem0
        what = f"boot_sharded (b) N={N} depth {len(BOOT_Q_BITS)} one-rank NCCL group"
        kernels.reset_launches()
        t1 = time.perf_counter()
        with held_against_plain(what, errs), div_round_sites(what) as sites:
            out = bs.regular_bootstrap(ctx, sct, skeys)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
        held_s = time.perf_counter() - t1
        local = out.c.to_local()
        same = torch.equal(local, boot_c) and out.level == keys.out_level
        err, p99 = boot_error(ctx, sk, ckks.Ciphertext(local, out.size, out.level, out.scale), z)
        print(f"{what}: residues identical to phase 13 (c)'s unsharded output: {same}; max error "
              f"{err:.3e} (limit {TOL_BOOT_PRECISE}), p99 {p99:.3e}; launches {launches}; ÷P "
              f"sites {dict(sites)}; held against plain {held_s:.1f} s; keys and input made "
              f"again in {remade_s:.1f} s (keygen {keygen_s:.1f} s); placing them added "
              f"{placed} bytes [{card}]")
        if not same or not err < TOL_BOOT_PRECISE:
            raise AssertionError(f"boot_sharded (b): residues differ from phase 13 (c)'s, or the "
                                 f"error {err} is above {TOL_BOOT_PRECISE}")
        require_launched(what, launches, ("ntt_fwd", "ntt_inv", "mac_keys", "base_conv",
                                          "div_round"))
        if launches["keyswitch2_fused"]:
            raise AssertionError(f"boot_sharded (b): K5 launched: {launches}")
        timed = {}
        for name, fn in (("sharded", lambda: bs.regular_bootstrap(ctx, sct, skeys)),
                         ("unsharded", lambda: ckks_boot.regular_bootstrap(ctx, ct, keys))):
            torch.cuda.reset_peak_memory_stats(dev)
            busy, wall, idle, per_kernel = device_idle_share(fn, 1)
            timed[name] = {"busy_ms": busy, "wall_ms": wall, "idle_share": idle,
                           "kernel_ms": own_kernels(per_kernel),
                           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        peak13 = boot_rec[f"n{N}"]["peak_bytes"]
        print(f"time boot_sharded (b): sharded on one rank busy {fmt_ms(timed['sharded']['busy_ms'])}"
              f" ms, wall {timed['sharded']['wall_ms']:.3f} ms, idle share "
              f"{fmt_ms(timed['sharded']['idle_share'])}; unsharded busy "
              f"{fmt_ms(timed['unsharded']['busy_ms'])} ms, wall "
              f"{timed['unsharded']['wall_ms']:.3f} ms, idle share "
              f"{fmt_ms(timed['unsharded']['idle_share'])}; peak memory_allocated sharded "
              f"{timed['sharded']['peak_bytes'] / 1e9:.3f} GB, unsharded "
              f"{timed['unsharded']['peak_bytes'] / 1e9:.3f} GB, phase 13 (c) "
              f"{peak13 / 1e9:.3f} GB; hand-written kernels, device ms sharded "
              f"{timed['sharded']['kernel_ms']} [{card}]")
        rec[f"n{N}"] = {"identical_to_phase13": same, "max_abs_err": err, "p99_abs_err": p99,
                        "launches": launches, "sites": dict(sites), "placed_bytes": placed,
                        "remade_s": remade_s, "held_s": held_s, "timed": timed,
                        "phase13_peak_bytes": peak13, "seconds": time.perf_counter() - t0}
    finally:
        dist.destroy_process_group()
    del ctx, sk, keys, ct, skeys, sct, out, local
    torch.cuda.empty_cache()
    return launches, rec


# The bootstrapping variants on limb-sharded ciphertexts (phase 22): (a) phase 14's
# v2 configuration at N=256 with keys made with limb_align=4, every run of v2_runs;
# (b) runs of phase 14 (b) at N=2^16, their keys made again from phase 14's
# generator state: V2_SHARDED_FULL in this script (less-key mode would take its time
# past its budget), and every run phase 14 keeps (V2_SHARDED_KEPT) in
# tools/chip_phase22.py.
V2_SHARDED_KEPT = ("regular", "NAND", "less_key")
V2_SHARDED_FULL = ("regular", "NAND")


def boot_v2_sharded_phase(dev, card, errs, refs, v2_rec, full=V2_SHARDED_FULL):
    """Phase 22: the bootstrapping variants on limb-sharded ciphertexts
    (parallel/boot_ext_sharded.py) on a one-rank NCCL group, keys placed by
    shard_pytree_limb_axis and inputs by shard_array_limb_axis.  (a) N=256:
    every run of v2_runs on limb_align=4 keys made on the CPU, the card's
    sharded residues, level and scale equal to the CPU plain path's
    unsharded result, K5 never launched.  (b) N: each run named in `full`
    on phase 14 (b)'s keys made again from its generator state (refs), one
    ~9 GB set at a time, launches counted from 0 and held against plain, K5
    never launched, K6 once a ÷P site; its residues, level and scale equal
    to phase 14 (b)'s output, the gates' error within TOL_V2_FULL; the
    launches against the staged route's rule (for each K5 launch of phase 14's run, one
    more K1 forward, K1 inverse and mac_keys, and base_conv a digit), the
    bytes the placement adds, peak memory_allocated, device busy, wall and
    idle share of one sharded run against one unsharded.  (c) The regular set
    of (a) is a compressed one that (a) runs expanded: regular v2 sharded on
    the same keys stripped equals (a)'s output, K7 once a stripped-key use;
    misuse: a plain-tensor ciphertext raises TypeError, a set stripped with
    no seeds ParameterError.  Returns (the launches of (b), summed; record)."""
    import torch
    import torch.distributed as dist
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.models import ckks_boot_ext as ext
    from heongpu_tpu_torch.parallel import boot_ext_sharded as bes
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.utils import errors, rng
    cfg = ext.BootConfigV2(**V2_CFG)
    rec = {}
    mesh = one_rank_group()
    try:
        place = lambda ct: ckks.Ciphertext(meshlib.shard_array_limb_axis(ct.c, mesh), ct.size,
                                           ct.level, ct.scale)
        # -- 22. (a) N=256, card against CPU ---------------------------------------------
        t0 = time.perf_counter()
        cctx = ckks.make_context(256, V2_Q_BITS, device="cpu", **V2_CTX)
        dctx = ckks.make_context(256, V2_Q_BITS, device=dev, **V2_CTX)
        g = rng.new_generator(31, "cpu")
        sk = ckks.keygen_secret(cctx, g, hamming_weight=V2_HW)
        pk = ckks.keygen_public(cctx, g, sk)
        skd = ckks.keygen_secret(cctx, g)
        runs = v2_runs(cctx, sk, pk, g, 256, skd, ckks.keygen_public(cctx, g, skd))
        to_dev = lambda c: place(ckks.Ciphertext(c.c.to(dev), c.size, c.level, c.scale))
        what = "boot_v2_sharded (a) N=256 one-rank NCCL group"
        keys_by, cpu_outs, same_a, card_outs = {}, {}, {}, {}
        for name, (kw, fn, inputs, _, _) in runs.items():
            if repr(kw) not in keys_by:
                keys_by[repr(kw)] = ext.generate_bootstrap_keys_v2(
                    cctx, g, skd if name == "sparse" else sk, cfg, limb_align=PAR_ALIGN,
                    compress_keys=name == "regular", **kw)
            cpu_outs[name] = fn(cctx, *inputs, keys_by[repr(kw)])
        # the regular set is a compressed one: (a) runs it whole, (c) stripped
        stripped_set = keys_by[repr({})]
        keys_by[repr({})] = expanded_keys(cctx, stripped_set)
        placed = {k: meshlib.shard_pytree_limb_axis(boot_keys_to(v, dev), mesh)
                  for k, v in keys_by.items()}
        kernels.reset_launches()
        with held_against_plain(what, errs), div_round_sites(what):
            for name, (kw, _, inputs, _, _) in runs.items():
                out = card_outs[name] = v2_entry(name, bes)(dctx, *map(to_dev, inputs),
                                                            placed[repr(kw)])
                torch.cuda.synchronize()
                want = cpu_outs[name]
                same_a[name] = (torch.equal(out.c.to_local().cpu(), want.c)
                                and (out.level, out.scale) == (want.level, want.scale))
            launches_a = dict(kernels.launches)
        print(f"{what}: {V2_CFG}, limb_align={PAR_ALIGN}: sharded residues, level and scale "
              f"identical to the CPU plain path's unsharded results: {same_a}; launches "
              f"{launches_a}; {time.perf_counter() - t0:.1f} s")
        if not all(same_a.values()) or launches_a["keyswitch2_fused"]:
            raise AssertionError("boot_v2_sharded (a): card and CPU differ, or K5 launched")
        rec["n256"] = {"identical_to_cpu": same_a, "launches": launches_a}

        # -- 22. (c) the regular set stripped; misuse ------------------------------------
        dkeys = placed[repr({})]
        dct = to_dev(runs["regular"][2][0])
        what = "boot_v2_sharded (c) N=256 regular v2 on stripped keys one-rank NCCL group"
        sdkeys = meshlib.shard_pytree_limb_axis(boot_keys_to(stripped_set, dev), mesh)
        with stripped_key_draws() as uses:
            kernels.reset_launches()
            with held_against_plain(what, errs), div_round_sites(what):
                got_c = bes.regular_bootstrap_v2(dctx, dct, sdkeys)
                torch.cuda.synchronize()
                launches_c = dict(kernels.launches)
        want = card_outs["regular"]
        same_c = (torch.equal(got_c.c.to_local(), want.c.to_local())
                  and (got_c.level, got_c.scale) == (want.level, want.scale))
        k7 = launches_c["threefry_uniform"]
        print(f"{what}: residues, level and scale identical to (a)'s on the keys whole: "
              f"{same_c}; K7 launched {k7} times for {uses[0]} stripped-key uses; launches "
              f"{launches_c}")
        if not same_c or not k7 == uses[0] > 0 or launches_c["keyswitch2_fused"]:
            raise AssertionError(f"boot_v2_sharded (c): stripped keys gave other residues, K7 "
                                 f"launched {k7} times for {uses[0]} uses, or K5 launched")
        misuse = {}
        try:
            bes.regular_bootstrap_v2(dctx, ckks.Ciphertext(dct.c.to_local(), 2, dct.level,
                                                           dct.scale), dkeys)
        except TypeError as e:
            misuse["plain_tensor"] = type(e).__name__
        try:
            bes.regular_bootstrap_v2(dctx, dct, stripped_without_seed(dkeys))
        except errors.ParameterError as e:
            misuse["stripped_key_set_without_seeds"] = type(e).__name__
        print(f"boot_v2_sharded (c) misuse: {misuse}")
        if set(misuse) != {"plain_tensor", "stripped_key_set_without_seeds"}:
            raise AssertionError(f"boot_v2_sharded (c): a misuse did not raise: {misuse}")
        rec["stripped"] = {"identical_to_a": same_c, "launches": launches_c,
                           "stripped_key_uses": uses[0]}
        rec["misuse"] = misuse
        del cctx, dctx, runs, keys_by, cpu_outs, card_outs, placed, dkeys, dct, stripped_set
        del sdkeys, got_c

        # -- 22. (b) phase 14 (b)'s runs at N, their keys made again ----------------------
        ctx, sk = refs["ctx"], refs["sk"]
        n = ctx.n
        total = dict.fromkeys(kernels.launches, 0)
        for name in full:
            ref = refs["runs"][name]
            t0 = time.perf_counter()
            torch.cuda.empty_cache()
            gen = rng.new_generator(41, dev)
            gen.set_state(ref["gen_state"])
            keys = ext.generate_bootstrap_keys_v2(ctx, gen, sk, cfg, **ref["kw"])
            torch.cuda.synchronize()
            remade_s = time.perf_counter() - t0
            mem0 = torch.cuda.memory_allocated(dev)
            skeys, sin = meshlib.shard_pytree_limb_axis(keys, mesh), [place(c) for c in
                                                                       ref["inputs"]]
            torch.cuda.synchronize()
            added = torch.cuda.memory_allocated(dev) - mem0
            sharded_fn = lambda f=v2_entry(name, bes): f(ctx, *sin, skeys)
            unsharded_fn = lambda f=v2_entry(name, ext): f(ctx, *ref["inputs"], keys)
            what = f"boot_v2_sharded (b) {name} N={n} one-rank NCCL group"
            kernels.reset_launches()
            t1 = time.perf_counter()
            with held_against_plain(what, errs), div_round_sites(what) as sites:
                out = sharded_fn()
                torch.cuda.synchronize()
                launches = dict(kernels.launches)
            held_s = time.perf_counter() - t1
            total = {k: total[k] + launches[k] for k in total}
            want = ref["out"]
            local = out.c.to_local()
            same = (torch.equal(local, want.c)
                    and (out.level, out.scale) == (want.level, want.scale))
            err, p99 = boot_error(ctx, sk, ckks.Ciphertext(local, out.size, out.level,
                                                           out.scale), ref["want"])
            tol = v2_tol(name, TOL_V2_FULL)
            # the staged route's rule: each K5 launch of the unsharded run becomes one more
            # K1 forward, K1 inverse and mac_keys (and a base_conv a digit)
            u = v2_rec[f"n{n}"][name]["launches"]
            k5 = u["keyswitch2_fused"]
            rule = {"ntt_fwd": u["ntt_fwd"] + k5, "ntt_inv": u["ntt_inv"] + k5,
                    "mac_keys": u["mac_keys"] + k5, "div_round": u["div_round"],
                    "keyswitch2_fused": 0}
            held_rule = all(launches[k] == v for k, v in rule.items())
            print(f"{what}: residues, level and scale identical to phase 14 (b)'s unsharded "
                  f"output: {same}; max error {err:.3e} ("
                  + (f"limit {tol}" if tol else "no limit at this N: phase 14") + f"), p99 "
                  f"{p99:.3e}; launches {launches}; phase 14's unsharded {u}; the staged route's rule "
                  f"{rule}: held {held_rule}, base_conv {launches['base_conv']} against "
                  f"{u['base_conv']} + one a digit; ÷P sites {dict(sites)}; held against plain "
                  f"{held_s:.1f} s; keys made again in {remade_s:.1f} s; placing them added "
                  f"{added} bytes [{card}]")
            if not same or (tol and not err < tol):
                raise AssertionError(f"boot_v2_sharded (b) {name}: residues differ from phase "
                                     f"14 (b)'s, or the error {err} is above {tol}")
            require_launched(what, launches, ("ntt_fwd", "ntt_inv", "mac_keys", "base_conv",
                                              "div_round"))
            if launches["keyswitch2_fused"]:
                raise AssertionError(f"boot_v2_sharded (b) {name}: K5 launched: {launches}")
            timed = {}
            for label, fn in (("sharded", sharded_fn), ("unsharded", unsharded_fn)):
                torch.cuda.reset_peak_memory_stats(dev)
                busy, wall, idle, per_kernel = device_idle_share(fn, 1)
                timed[label] = {"busy_ms": busy, "wall_ms": wall, "idle_share": idle,
                                "kernel_ms": own_kernels(per_kernel),
                                "peak_bytes": torch.cuda.max_memory_allocated(dev)}
            sh, un = timed["sharded"], timed["unsharded"]
            print(f"time boot_v2_sharded (b) {name}: sharded on one rank busy "
                  f"{fmt_ms(sh['busy_ms'])} ms, wall {sh['wall_ms']:.3f} ms, idle share "
                  f"{fmt_ms(sh['idle_share'])}; unsharded busy {fmt_ms(un['busy_ms'])} ms, wall "
                  f"{un['wall_ms']:.3f} ms, idle share {fmt_ms(un['idle_share'])}; peak "
                  f"memory_allocated sharded {sh['peak_bytes'] / 1e9:.3f} GB, unsharded "
                  f"{un['peak_bytes'] / 1e9:.3f} GB; hand-written kernels, device ms sharded "
                  f"{sh['kernel_ms']}, unsharded {un['kernel_ms']} [{card}]")
            rec[f"n{n}_{name}"] = {
                "identical_to_phase14": same, "max_abs_err": err, "p99_abs_err": p99,
                "launches": launches, "phase14_launches": u, "rule": rule,
                "rule_held": held_rule, "sites": dict(sites), "placed_bytes": added,
                "remade_s": remade_s, "held_s": held_s, "timed": timed,
                "seconds": time.perf_counter() - t0}
            del keys, skeys, sin, out, local, sharded_fn, unsharded_fn
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return total, rec


# Stripped keys on the limb-sharded paths and the reference's key sets in the
# port's loader (phase 23).  The seeded keys' a_seed: below 2^32 and apart (the
# port's rule; the reference's compressed layout at 2^34 and up keeps only the
# seed mod 2^32).
STRIP_SEEDS = (2 ** 31 + 11, 2 ** 31 + 12)    # the relin key's and the Galois key's
K7_ROW_SPLIT = 4       # ranks of the row blocks K7 draws in (a)
K7_ODD_ROWS = (13, 28)     # an odd block: rows 13..40 of the 54


def depth48_qp_primes(n):
    """The depth-48 chain's QP primes (BOOT_Q_BITS, then BOOT_CTX's six 30-bit
    special primes) in the order ckks.make_context generates them, before it
    pairs the scale primes."""
    from heongpu_tpu_torch.utils import nt
    used, q = set(), []
    for b in BOOT_Q_BITS:
        pr = nt.generate_ntt_primes(b, 1, n, exclude=used)[0]
        used.add(pr)
        q.append(pr)
    return q + nt.generate_ntt_primes(30, BOOT_CTX["p_count"], n, exclude=used)


def k7_row_blocks(rows: int, split: int = K7_ROW_SPLIT) -> list:
    """(first, count) of each rank's block of `rows` limbs split `split` ways
    as torch.chunk splits them, and K7_ODD_ROWS."""
    m = -(-rows // split)
    return [(lo, min(m, rows - lo)) for lo in range(0, rows, m)] + [K7_ODD_ROWS]


def v2_wire_fields(keys) -> dict:
    """interop.boot_keys_v2_from_numpy's arguments for a BootKeysV2: every
    array as the reference's numpy uint32 (interop.to_numpy), seeds and
    stripped halves kept."""
    import dataclasses
    from heongpu_tpu_torch import interop
    u = interop.to_numpy
    key = lambda k: None if k is None else {"k0": u(k.k0), "k1": u(k.k1), "a_seed": k.a_seed}
    gal = lambda k: {f: u(getattr(k, f)) for f in ("k0", "k1", "perm_coeff_src",
                                                   "perm_coeff_neg", "perm_ntt", "galois_elt",
                                                   "inv_form", "a_seed")}
    piece = lambda p: dict(level=p.level, n1=p.n1, pt_scale=p.pt_scale, depth=p.depth,
                           giants=[(g, b, u(pts)) for g, b, pts in p.giants])
    return dict(gk={e: gal(k) for e, k in keys.gk.keys.items()}, rk=key(keys.rk),
                cfg=dataclasses.asdict(keys.cfg), msg_scale=keys.msg_scale, variant=keys.variant,
                ctos_pieces=[piece(p) for p in keys.ctos_pieces],
                stoc_pieces=[piece(p) for p in keys.stoc_pieces],
                mult_i=[u(t) for t in keys.mult_i], mult_neg_i=[u(t) for t in keys.mult_neg_i],
                cos_coeffs=keys.cos_coeffs, swk_to_sparse=key(keys.swk_to_sparse),
                swk_to_dense=key(keys.swk_to_dense))


def k7_row_range_checks(dev, card, errs):
    """Phase 23 (a): K7's row range on the card, over the depth-48 key's 54 QP
    limbs, a (12, N) draw moved behind the digit axis in Montgomery form (the
    largest Galois key's k1): each rank's block of a 4-way split and the odd
    block K7_ODD_ROWS, each equal to the plain version's same row range on the
    card and to the same rows of K7's whole draw; the row-range draw of the
    second block timed (time_kernels' "threefry_uniform rows").  Returns
    (record, time_kernels' record)."""
    import torch
    from heongpu_tpu_torch.utils import threefry
    primes = depth48_qp_primes(N)
    shape, seed = (12, N), 2 ** 34 + 23
    key = threefry.key_from_seed(seed)
    whole = threefry.uniform_rns_cuda(key, primes, shape, dev, True, True)
    out = {}
    for lb, lc in k7_row_blocks(len(primes)):
        got = threefry.uniform_rns_cuda(key, primes, shape, dev, True, True, (lb, lc))
        e_plain = max_err(got, threefry.uniform_rns_plain(key, primes, shape, dev, True, True,
                                                          (lb, lc)))
        e_whole = max_err(got, whole[:, lb:lb + lc])
        torch.cuda.synchronize()
        errs["threefry_uniform"] = max(errs["threefry_uniform"], e_plain, e_whole)
        out[f"{lb}..{lb + lc - 1}"] = {"against_plain": e_plain, "against_whole": e_whole}
        print(f"K7 threefry_uniform rows {lb}..{lb + lc - 1} of {shape} x {len(primes)} limbs "
              f"(moved, Montgomery): err={e_plain} against the plain row range, err={e_whole} "
              f"against the rows of K7's whole draw")
    if any(v for r in out.values() for v in r.values()):
        raise AssertionError(f"K7's row range differs from the plain version or the whole draw: "
                             f"{out}")
    kern = time_kernels({**threefry_shapes(primes, shape, dev, "depth-48 key", seed),
                         **threefry_shapes(primes, shape, dev, "depth-48 key, a rank's block",
                                           seed, rows=k7_row_blocks(len(primes))[1])},
                        "the depth-48 key's", N, card, errs)
    del whole
    return out, kern


def stripped_phase(dev, card, errs, ctx, sk):
    """Phase 23: stripped (seeded) keys on the limb-sharded paths, and the
    reference's key sets in the port's loader.  (a) k7_row_range_checks.
    (b) On a one-rank NCCL group at the main path's width (ctx, sk: N=2^16,
    twelve 29-bit Q primes, Method II, alpha 4): a relin key and a Galois key
    (step 1) seeded (STRIP_SEEDS) and stripped, placed by
    shard_pytree_limb_axis; multiply -> relinearize -> rescale -> rotate by 1
    on two fresh ciphertexts, launches counted from 0 and held against plain:
    K7 once a stripped-key use (two), K5 never, K6 once a keyswitch; every
    result equal to the unsharded entry points' on the same stripped keys and
    on the keys whole; a stripped key with no seed raises ParameterError.
    (c) The reference's objects on the card: a BootKeysV2 (phase 14's chain
    at N=256, compress_keys=True, made on the CPU) and a TFHE BootKey
    (STD128, made on the card), each written by the port's serializer in the
    reference's format and loaded onto the card; regular v2 (unsharded, and
    sharded on the placed set) and NAND on the loaded keys equal to the same
    runs on the keys interop builds from their numpy arrays.  Returns
    (launches of (b), record)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from heongpu_tpu_torch import interop, kernels
    from heongpu_tpu_torch.models import ckks, ringkit, tfhe
    from heongpu_tpu_torch.models import ckks_boot_ext as ext
    from heongpu_tpu_torch.parallel import boot_ext_sharded as bes
    from heongpu_tpu_torch.parallel import ckks_sharded as cks
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.utils import errors, rng, serializer
    t0 = time.perf_counter()
    rec = {}
    # -- 23. (a) K7's row range -------------------------------------------------------
    rec["k7_rows"], rec["kernels"] = k7_row_range_checks(dev, card, errs)

    # -- 23. (b) the sharded step on stripped keys ------------------------------------
    g = rng.new_generator(230, dev)
    rk_full = ckks.keygen_relin(ctx, g, sk, a_seed=STRIP_SEEDS[0])
    gk_full = ckks.keygen_galois(ctx, g, sk, steps=[1], include_conj=False,
                                 a_seed=STRIP_SEEDS[1])
    rk, gk = ringkit.strip_seeded(rk_full), ringkit.strip_seeded(gk_full)
    pk = ckks.keygen_public(ctx, g, sk)
    z = np.random.default_rng(230).uniform(-1, 1, N // 2)
    a, b = (ckks.encrypt(ctx, pk, ckks.encode(ctx, v), g) for v in (z, z[::-1].copy()))

    def step(mod, rk_, gk_, x, y):
        out = {"mult": mod.multiply(ctx, x, y)}
        out["relin"] = mod.relinearize(ctx, out["mult"], rk_)
        out["rescale"] = mod.rescale(ctx, out["relin"])
        out["rotate"] = mod.rotate(ctx, out["rescale"], gk_, 1)
        return out

    full = step(ckks, rk_full, gk_full, a, b)
    with stripped_key_draws() as uses_u:
        kernels.reset_launches()
        unsharded = step(ckks, rk, gk, a, b)
        torch.cuda.synchronize()
        launches_u = dict(kernels.launches)
    mesh = one_rank_group()
    try:
        place = lambda ct: ckks.Ciphertext(meshlib.ct_sharding(mesh).place(ct.c), ct.size,
                                           ct.level, ct.scale)
        srk, sgk = (meshlib.shard_pytree_limb_axis(k, mesh) for k in (rk, gk))
        sa, sb = place(a), place(b)
        what = f"stripped keys (b) sharded step N={N} one-rank NCCL group"
        with stripped_key_draws() as uses:
            kernels.reset_launches()
            t1 = time.perf_counter()
            with held_against_plain(what, errs), div_round_sites(what) as sites:
                sharded = step(cks, srk, sgk, sa, sb)
                torch.cuda.synchronize()
                launches = dict(kernels.launches)
            held_s = time.perf_counter() - t1
        same = {op: torch.equal(sharded[op].c.to_local(), unsharded[op].c)
                and torch.equal(unsharded[op].c, full[op].c) for op in full}
        k7 = launches["threefry_uniform"]
        dec = ckks.decode(ctx, ckks.decrypt(ctx, sk, ckks.Ciphertext(
            sharded["rotate"].c.to_local(), 2, sharded["rotate"].level,
            sharded["rotate"].scale)))
        want = np.roll(z * z[::-1], -1)
        dec_err = float(np.abs(dec - want).max())
        print(f"{what}: mult -> relin -> rescale -> rotate(1) on a stripped relin key (a_seed "
              f"{rk.a_seed}) and Galois key (a_seed {STRIP_SEEDS[1]}), each op equal to the "
              f"unsharded entry points on the same stripped keys and on the keys whole: {same}; "
              f"K7 launched {k7} times for {uses[0]} stripped-key uses (unsharded: "
              f"{launches_u['threefry_uniform']} for {uses_u[0]}); launches {launches}; ÷P sites "
              f"{dict(sites)}; decode of the rotation {dec_err:.3e} (limit "
              f"{TOL_DECODE + 4 * keyswitch_noise(ctx):.3e}); held against plain {held_s:.1f} s")
        if not all(same.values()):
            raise AssertionError(f"stripped keys (b): the sharded step differs: {same}")
        if not k7 == uses[0] == 2 or launches["keyswitch2_fused"]:
            raise AssertionError(f"stripped keys (b): K7 launched {k7} times for {uses[0]} uses "
                                 f"(2 expected), or K5 launched: {launches}")
        require_launched(what, launches, ("ntt_fwd", "ntt_inv", "base_conv", "mac_keys",
                                          "div_round", "threefry_uniform"))
        if not np.isfinite(dec).all() or not dec_err <= TOL_DECODE + 4 * keyswitch_noise(ctx):
            raise AssertionError(f"stripped keys (b): the rotation decodes {dec_err} off")
        misuse = {}
        try:
            cks.relinearize(ctx, sharded["mult"], dataclasses.replace(srk, a_seed=None))
        except errors.ParameterError as e:
            misuse["stripped_key_without_seed"] = type(e).__name__
        if not misuse:
            raise AssertionError("stripped keys (b): a stripped key with no seed did not raise")
        rec["sharded_step"] = {"identical": same, "launches": launches,
                               "unsharded_launches": launches_u, "stripped_key_uses": uses[0],
                               "sites": dict(sites), "decode_err": dec_err, "held_s": held_s,
                               "misuse": misuse}
        del full, unsharded, sharded, srk, sgk, sa, sb

        # -- 23. (c) the reference's key sets through the port's loader, on the card -----
        t1 = time.perf_counter()
        cctx = ckks.make_context(256, V2_Q_BITS, device="cpu", **V2_CTX)
        dctx = ckks.make_context(256, V2_Q_BITS, device=dev, **V2_CTX)
        cg = rng.new_generator(232, "cpu")
        csk = ckks.keygen_secret(cctx, cg, hamming_weight=V2_HW)
        cpk = ckks.keygen_public(cctx, cg, csk)
        keys = ext.generate_bootstrap_keys_v2(cctx, cg, csk, ext.BootConfigV2(**V2_CFG),
                                              compress_keys=True)
        wire = serializer.serialize(keys)
        loaded = serializer.deserialize(wire, device=dev)
        carried = interop.boot_keys_v2_from_numpy(**v2_wire_fields(keys), device=dev)
        (ct,), _, _ = v2_runs(cctx, csk, cpk, cg, 256, csk, cpk)["regular"][2:]
        dct = ckks.Ciphertext(ct.c.to(dev), ct.size, ct.level, ct.scale)
        on_loaded = ext.regular_bootstrap_v2(dctx, dct, loaded)
        on_carried = ext.regular_bootstrap_v2(dctx, dct, carried)
        sharded_v2 = bes.regular_bootstrap_v2(dctx, place(dct),
                                              meshlib.shard_pytree_limb_axis(loaded, mesh))
        same_v2 = {"unsharded": torch.equal(on_loaded.c, on_carried.c),
                   "sharded": torch.equal(sharded_v2.c.to_local(), on_carried.c),
                   "cos_coeffs": loaded.cos_coeffs.dtype == np.float64
                   and np.array_equal(loaded.cos_coeffs, keys.cos_coeffs)}
        print(f"stripped keys (c) N=256 BootKeysV2 (compressed, {len(wire)} bytes in the "
              f"reference's format, loaded onto the card): regular v2 on the loaded set equal to "
              f"the run on interop's set: {same_v2}")
        tctx = tfhe.make_context(device=dev)
        tg = rng.new_generator(233, dev)
        tsk = tfhe.keygen_secret(tg, tctx.n, device=dev)
        bk = tfhe.keygen_boot(tctx, tg, tsk)
        twire = serializer.serialize(bk, level=1)
        tloaded = serializer.deserialize(twire, device=dev)
        u = interop.to_numpy
        tcarried = interop.tfhe_boot_key_from_numpy(u(bk.bk), u(bk.ksk_a), u(bk.ksk_b),
                                                    device=dev)
        r = np.random.default_rng(233)
        x, y = (r.integers(0, 2, TFHE_B).astype(bool) for _ in range(2))
        cx, cy = (tfhe.encrypt(tctx, tsk, v, tg) for v in (x, y))
        n_loaded, n_carried = (tfhe.NAND(tctx, k, cx, cy) for k in (tloaded, tcarried))
        same_nand = (torch.equal(n_loaded.a, n_carried.a) and torch.equal(n_loaded.b, n_carried.b)
                     and np.array_equal(tfhe.decrypt(tctx, tsk, n_loaded), ~(x & y)))
        print(f"stripped keys (c) TFHE BootKey at n={tctx.n} ({len(twire)} bytes in the "
              f"reference's format, loaded onto the card): NAND at B={TFHE_B} equal to the run on "
              f"interop's key and to the truth table: {same_nand}; "
              f"{time.perf_counter() - t1:.1f} s [{card}]")
        if not all(same_v2.values()) or not same_nand:
            raise AssertionError(f"stripped keys (c): runs on the loaded keys differ: {same_v2}, "
                                 f"NAND {same_nand}")
        rec["loader"] = {"v2": same_v2, "v2_bytes": len(wire), "nand": same_nand,
                         "boot_key_bytes": len(twire)}
    finally:
        dist.destroy_process_group()
    rec["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return launches, rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "script runs the port on a CUDA GPU only")
    return run(torch.device("cuda"))


def run(dev) -> int:
    """All phases on `dev` (the card; main() checks that there is one)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.kernels import build
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.ops import keyswitch_fused as ksf
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.ops import rns
    from heongpu_tpu_torch.utils import nt, rng

    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"card: {card}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    path, log = build.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {path.name}")
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print("  ptxas:", line.strip())
    ptxas = {("blind_rotate2" if "Lb1E" in fn else "blind_rotate"): line
             for fn, line in ptxas_summary(log, "blind_rotate_kernel").items()}
    for name, line in ptxas.items():
        print(f"ptxas tfhe.cu {name}: {line}")
    if log and len(ptxas) != 2:
        raise AssertionError(f"no ptxas line for both blind-rotation kernels: {ptxas}")
    ks_ptxas = {}
    for fn, line in ptxas_summary(log, "keyswitch2_fused_kernel").items():
        l1, l2 = map(int, re.search(r"ILi(\d+)ELi(\d+)E", fn).groups())
        ks_ptxas[(1 << l1, 1 << l2)] = line
    for (n1, n2), line in sorted(ks_ptxas.items()):
        print(f"ptxas keyswitch.cu keyswitch2_fused (n1, n2) = ({n1}, {n2}): {line}")
    if log and len(ks_ptxas) != 9:
        raise AssertionError(f"no ptxas line for each of K5's nine shapes: {ks_ptxas}")
    if (256, 256) in ks_ptxas:
        ptxas["keyswitch2_fused"] = ks_ptxas[(256, 256)]
    ntt_ptxas = {}
    for fn, line in ptxas_summary(log, "ntt_").items():
        name, l1, l2, split = re.search(r"(ntt_(?:fwd|inv)[12])ILi(\d+)ELi(\d+)ELb([01])E",
                                        fn).groups()
        ntt_ptxas[(name, 1 << int(l1), 1 << int(l2), split == "1")] = line
    for (name, n1, n2, split), line in sorted(ntt_ptxas.items()):
        print(f"ptxas ntt.cu {name}{' split' if split else ''} (n1, n2) = ({n1}, {n2}): {line}")
    if log and len(ntt_ptxas) != 2 * 4 * 9:
        raise AssertionError(f"no ptxas line for each of K1's four passes at nine shapes, whole "
                             f"and split: {ntt_ptxas}")
    k2k6_ptxas = {}
    for fn, line in ptxas_summary(log, "base_conv_kernel").items():
        kp, scaled, chunked = re.search(r"base_conv_kernelILi(\d+)ELb([01])ELb([01])E", fn).groups()
        k2k6_ptxas[("base_conv", int(kp), scaled == "1", chunked == "1")] = line
    for fn, line in ptxas_summary(log, "div_round_").items():
        kind, p_, exact = re.search(r"div_round_(column|tile)_kernelILi(\d+)ELb([01])E",
                                    fn).groups()
        k2k6_ptxas[("div_exact_t" if exact == "1" else "div_round", kind, int(p_))] = line
    for key, line in sorted(k2k6_ptxas.items()):
        print(f"ptxas {'mac.cu' if key[0] == 'base_conv' else 'divround.cu'} {key}: {line}")
    if log and len(k2k6_ptxas) != 2 * 9 + 2 * (rns.DIV_ROUND_MAX_STAGES + 8):
        raise AssertionError(f"no ptxas line for each of K2 base_conv's nine instances "
                             f"(both forms) and K6's stage counts in both modes (the tile "
                             f"kernel at 1 to 16, the whole-column one at 1 to 8): "
                             f"{k2k6_ptxas}")
    k7_ptxas = list(ptxas_summary(log, "threefry_uniform_kernel").values())
    for line in k7_ptxas:
        print(f"ptxas threefry.cu threefry_uniform: {line}")
    if log and len(k7_ptxas) != 1:
        raise AssertionError(f"no ptxas line for K7: {k7_ptxas}")
    if k7_ptxas:
        ptxas["threefry_uniform"] = k7_ptxas[0]
    k7w_ptxas = list(ptxas_summary(log, "threefry_bits_kernel").values())
    for line in k7w_ptxas:
        print(f"ptxas threefry.cu threefry_bits: {line}")
    if log and len(k7w_ptxas) != 1:
        raise AssertionError(f"no ptxas line for K7's raw-words mode: {k7w_ptxas}")
    if k7w_ptxas:
        ptxas["threefry_bits"] = k7w_ptxas[0]
    # K7's bound takes 2 x 20 funnel shifts and 2 x 21 xors a word as ALU-only work (20
    # and 21 in the raw-words mode): the compiled kernels must hold at least those for
    # each of the words a thread computes (they run straight through a thread's words)
    k7_src = (build.CSRC / "threefry.cu").read_text()
    for kern, macro, shf_min, lop_min in (("threefry_uniform", "K7_WORDS", 2 * 20, 2 * 21),
                                          ("threefry_bits", "K7_BITS_WORDS", 20, 21)):
        words = int(re.search(rf"#define {macro} (\d+)\n", k7_src).group(1))
        mix = sass_mix(path, f"{kern}_kernel")
        shf = sum(v for k, v in mix.items() if k.startswith("SHF.L.W"))
        lop3 = mix.get("LOP3.LUT", 0)
        print(f"SASS threefry.cu {kern}: {sum(mix.values())} instructions for {words} words a "
              f"thread; {shf} funnel shifts, {lop3} LOP3, "
              f"{sum(v for k, v in mix.items() if k.startswith('IMAD'))} IMAD (FMA pipe), "
              f"{sum(v for k, v in mix.items() if k.startswith('IADD3'))} IADD3; gate "
              f">= {words * shf_min} SHF.L.W and >= {words * lop_min} LOP3.LUT; "
              + json.dumps(dict(sorted(mix.items(), key=lambda kv: -kv[1]))))
        if shf < words * shf_min or lop3 < words * lop_min:
            raise AssertionError(f"{kern}'s SASS holds fewer shifts or xors than its bound "
                                 f"counts for {words} words: {shf} SHF.L.W, {lop3} LOP3.LUT")
    spills = [k for k, line in list(ks_ptxas.items()) + list(ntt_ptxas.items())
              + list(k2k6_ptxas.items()) + [("threefry_uniform", ln) for ln in k7_ptxas]
              + [("threefry_bits", ln) for ln in k7w_ptxas]
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
    if spills:
        raise AssertionError(f"K1, K2, K5, K6 or K7 instances spill: {spills}")
    for d in ("fwd", "inv"):
        if (f"ntt_{d}1", 256, 256, False) in ntt_ptxas:
            ptxas[f"ntt_{d}"] = "; ".join(
                f"pass {k}: {ntt_ptxas[(f'ntt_{d}{k}', 256, 256, False)]}" for k in (1, 2))
    if ("ntt_fwd1", 256, 256, True) in ntt_ptxas:
        ptxas["ntt_pass"] = "; ".join(f"{d}{k}: {ntt_ptxas[(f'ntt_{d}{k}', 256, 256, True)]}"
                                      for d in ("fwd", "inv") for k in (1, 2))

    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    errs = dict.fromkeys(kernels.launches, 0)

    def check_ntt(tb, rows, what):
        polys = rows // tb.num_limbs
        x = rand_residues(list(tb.primes) * polys, (rows, tb.n), gen, dev)
        x = x.view(polys, tb.num_limbs, tb.n)
        f = nttm.ntt_cuda(x, tb, inverse=False)
        e_f = max_err(f, nttm.ntt_fwd_plain(x, tb))
        i = nttm.ntt_cuda(f, tb, inverse=True)
        e_i = max(max_err(i, nttm.ntt_inv_plain(f, tb)), max_err(i, x))
        torch.cuda.synchronize()
        errs["ntt_fwd"] = max(errs["ntt_fwd"], e_f)
        errs["ntt_inv"] = max(errs["ntt_inv"], e_i)
        print(f"K1 ntt {what}: N={tb.n} rows={rows} limbs={tb.num_limbs} "
              f"fwd_err={e_f} inv_err={e_i}")
        if e_f or e_i:
            raise AssertionError(f"NTT kernel disagrees with the plain version ({what})")

    def time_ntt(tb, polys, inverse):
        """K1 on random residues (polys, limbs, N): kernel and plain ms (CUDA events
        around back-to-back calls, so the host's launch rate where the device is
        faster), the bound, and the device ms of each of its two passes and of both
        (torch.profiler)."""
        rows = polys * tb.num_limbs
        (kern, plain, shape, bnd), = ntt_shapes(tb, polys, inverse, gen, dev).values()
        ms = cuda_ms(kern, reps=20)
        pms = cuda_ms(plain, reps=3)
        dev_ms, own, traced, made = traced_device_ms(kern, 10)
        passes = {k.split("<")[0]: v for k, v in own.items()}
        name = "ntt_inv" if inverse else "ntt_fwd"
        print(f"time {name} {shape}, {rows} rows: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}); device {fmt_ms(dev_ms)} ms"
              f"{dropped_note(traced, made)}, by pass "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(passes.items())) + f" [{card}]")
        return {"shape": shape, "rows": rows, "ms": ms, "plain_ms": pms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "device_ms": dev_ms, "passes": passes}

    # -- 3. K1 against plain at each of its nine shapes (2^10: phase 8, 2^16: below) --
    for n in (1 << 8, 1 << 9, 1 << 11, 1 << 12, 1 << 13, 1 << 14, 1 << 15):
        tb = nttm.build_ntt_tables(nt.generate_ntt_primes(29, 4, n), n, device=dev)
        check_ntt(tb, 8, "small")

    # -- main-path context (the N=2^16 tables of phases 3-7) -----------------
    t0 = time.perf_counter()
    ctx = ckks.make_context(N, Q_BITS, ks_type="II", alpha=ALPHA, device=dev)
    print(f"context: N={N} q={len(ctx.q_primes)}x29b p={len(ctx.p_primes)}x30b "
          f"alpha={ALPHA} digits={len(ctx.ks2[0].groups)} "
          f"built in {time.perf_counter() - t0:.1f} s")
    check_ntt(ctx.ntt_q(0), 12, "12-limb Q table")
    check_ntt(ctx.ntt_q(0), 24, "12-limb Q table, 2 polys")
    check_ntt(ctx.ntt_qp, 16, "16-limb QP table")
    check_ntt(ctx.ntt_qp, 48, "16-limb QP table, 3 digits")
    check_ntt(ctx.ntt_qp_at(1), 30, "leveled concatenated 11+4-limb table")

    # -- 4. K2 and K5 against plain ----------------------------------------------
    qp = list(ctx.qp_primes)
    d = rand_residues(qp * 3, (48, N), gen, dev).view(3, 16, N)
    k0 = rand_residues(qp * 3, (48, N), gen, dev).view(3, 16, N)
    k1 = rand_residues(qp * 3, (48, N), gen, dev).view(3, 16, N)
    errs["mac_keys"] = max_err(rns.mac_keys_cuda(d, k0, k1, ctx.base_qp),
                               mac_keys_plain(d, k0, k1, ctx.base_qp))
    print(f"K2 mac_keys (3, 16, {N}): err={errs['mac_keys']}")
    conv_cases = [(ctx.ks2[0].convs[0], "4 -> 16"), (ctx.ks2[2].convs[2], "2 -> 14")]
    for conv, what in conv_cases:
        k_in = conv.mat_mont.shape[0]
        z = rand_residues([int(v) for v in conv.ibase.p.tolist()], (k_in, N), gen, dev)
        e = max_err(rns.base_conv_cuda(z, conv.mat_mont, conv.obase),
                    rns.base_conv_plain(z, conv.mat_mont, conv.obase))
        e_s = max_err(rns.base_conv_cuda(z, conv.mat_mont, conv.obase, conv.scale),
                      rns.base_conv_plain(z, conv.mat_mont, conv.obase, conv.scale))
        errs["base_conv"] = max(errs["base_conv"], e, e_s)
        print(f"K2 base_conv ({what}, {N}): err={e}, with the scaling fused err={e_s}")
    # K6: Method II's four stages at levels 0 and 1, the encryption's, one stage
    for chain, what in ((ctx.ks2[0].div_stages, "keyswitch level 0"),
                        (ctx.ks2[1].div_stages, "keyswitch level 1"),
                        (ctx.enc_div, "encryption"), (ctx.div_p.chain, "one stage")):
        x = rand_residues(list(ctx.qp_primes[:chain.k]) + list(ctx.p_primes[:len(chain)]),
                          (chain.k + len(chain), N), gen, dev).repeat(2, 1, 1)
        e = max_err(rns.div_round_cuda(x, chain), rns.div_round_chain_plain(x, chain))
        errs["div_round"] = max(errs["div_round"], e)
        print(f"K6 div_round ({what}: {tuple(x.shape)}, p={len(chain)}): err={e}")
    # widths no path of this script runs, at N=4096: BFV's lifts on smaller chains (5 -> 3,
    # 14 -> 16), 62 input limbs (two chunks of K2's widest instance) at B=3; K6 over 8
    # stages, and over 20 (two launches: 16 stages, then 4)
    pr = nt.generate_ntt_primes(29, 126, 4096)
    for k_in, k_out in ((5, 3), (14, 16), (62, 64)):
        conv = rns.BaseConv.build(pr[:k_in], pr[k_in:k_in + k_out], dev)
        z = rand_residues(pr[:k_in] * 3, (3 * k_in, 4096), gen, dev).view(3, k_in, 4096)
        e = max(max_err(rns.base_conv_cuda(z, conv.mat_mont, conv.obase, *sc),
                        rns.base_conv_plain(z, conv.mat_mont, conv.obase, *sc))
                for sc in ((), (conv.scale,)))
        errs["base_conv"] = max(errs["base_conv"], e)
        print(f"K2 base_conv ({k_in} -> {k_out}, B=3, 4096), both forms: err={e}")
    for k, p in ((12, 8), (6, 20)):
        stages, remaining = [], pr[:k + p]
        for sp in reversed(pr[k:k + p]):
            remaining = remaining[:-1]
            stages.append(rns.DivRoundLastq.build(remaining, sp, dev))
        chain = rns.DivRoundChain.build(stages)
        x = rand_residues(pr[:k + p] * 2, (2 * (k + p), 4096), gen, dev).view(2, k + p, 4096)
        e = max_err(rns.div_round_cuda(x, chain), rns.div_round_chain_plain(x, chain))
        errs["div_round"] = max(errs["div_round"], e)
        print(f"K6 div_round ({tuple(x.shape)}, p={p}, {len(chain.pieces)} launches): err={e}")
    # K6's t-exact mode (BGV's divisions): one stage over 29 + 1 limbs at N=2^15 (a BGV
    # keyswitch), three stages and twenty (two launches) at N=4096; K7 (the seeded keys'
    # draw): a public key's row and d rows moved behind the limb axis, in Montgomery form
    from heongpu_tpu_torch.utils import threefry
    t_bgv = nt.generate_ntt_primes(20, 1, 1 << 15)[0]
    pr15 = nt.generate_ntt_primes(29, 30, 1 << 15)
    for k, p, primes, n_ in ((29, 1, pr15, 1 << 15), (12, 3, pr, 4096), (6, 20, pr, 4096)):
        stages, remaining = [], primes[:k + p]
        for sp in reversed(primes[k:k + p]):
            remaining = remaining[:-1]
            stages.append(rns.DivExactT.build(remaining, sp, t_bgv, dev))
        chain = rns.DivRoundChain.build(stages)
        x = rand_residues(primes[:k + p] * 2, (2 * (k + p), n_), gen, dev).view(2, k + p, n_)
        e = max_err(rns.div_round_cuda(x, chain), rns.div_round_chain_plain(x, chain))
        errs["div_exact_t"] = max(errs["div_exact_t"], e)
        print(f"K6 div_exact_t ({tuple(x.shape)}, p={p}, {len(chain.pieces)} launches): err={e}")
    for primes, shape, moved in ((pr15, (1 << 15,), False), (pr[:16], (3, 4096), True)):
        key = threefry.key_from_seed(2 ** 43 + len(primes))
        e = max_err(threefry.uniform_rns_cuda(key, primes, shape, dev, moved, True),
                    threefry.uniform_rns_plain(key, primes, shape, dev, moved, True))
        errs["threefry_uniform"] = max(errs["threefry_uniform"], e)
        print(f"K7 threefry_uniform ({len(primes)} limbs, {shape}, moved={moved}): err={e}")
    # K7's raw-words mode: an odd count (a partial last block), a multi-axis draw, 2^22 words
    for shape in ((5,), (3, 7, 1000), (1 << 22,)):
        key = threefry.key_from_seed(2 ** 43 + len(shape))
        e = max_err(threefry.bits32_cuda(key, shape, dev), threefry.bits32_plain(key, shape, dev))
        errs["threefry_bits"] = max(errs["threefry_bits"], e)
        print(f"K7 threefry_bits {shape}: err={e}")
    torch.cuda.synchronize()
    if any(errs[k] for k in ("mac_keys", "base_conv", "div_round", "div_exact_t",
                             "threefry_uniform", "threefry_bits")):
        raise AssertionError("K2, K6 or K7 disagrees with its plain version")

    small = ckks.make_context(1 << 12, Q_BITS, ks_type="II", alpha=ALPHA, device=dev)
    for c, level in ((small, 0), (small, 1), (ctx, 0), (ctx, 1)):
        args = fused_inputs(c, level, gen)
        got = ksf.keyswitch2_fused_cuda(*args)
        e_p = max_err(got, ksf.keyswitch2_fused_core_plain(*args))
        e_s = max_err(got, staged_route(c, level, args))
        torch.cuda.synchronize()
        errs["keyswitch2_fused"] = max(errs["keyswitch2_fused"], e_p, e_s)
        print(f"K5 keyswitch2_fused N={c.n} level {level}: z {tuple(args[0].shape)}, "
              f"keys {tuple(args[2].shape)}, groups {args[5]}: err={e_p} against the plain "
              f"core, err={e_s} against the staged route")
        if e_p or e_s:
            raise AssertionError("K5 disagrees with keyswitch2_fused_core_plain or the staged route")

    # -- 5. the main path -------------------------------------------------------
    z = np.linspace(-1.0, 1.0, N // 2)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with held_against_plain("CKKS main path", errs), div_round_sites("CKKS main path"):
        g = rng.new_generator(1, dev)
        sk = ckks.keygen_secret(ctx, g)
        pk = ckks.keygen_public(ctx, g, sk)
        rk = ckks.keygen_relin(ctx, g, sk)
        ct1 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z), g)
        ct2 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z[::-1].copy()), g)
        out = ct1
        for _ in range(K_CHAIN):
            out = ckks.relinearize(ctx, ckks.multiply(ctx, out, ct2), rk)
            out = ckks.Ciphertext(out.c, 2, 0, ctx.default_scale)
        relin = ckks.relinearize(ctx, ckks.multiply(ctx, ct1, ct2), rk)
        res = ckks.rescale(ctx, relin)
        dec = ckks.decode(ctx, ckks.decrypt(ctx, sk, res))
        res1 = ckks.rescale(ctx, ckks.relinearize(ctx, ckks.multiply(ctx, res, res), rk))
        dec1 = ckks.decode(ctx, ckks.decrypt(ctx, sk, res1))
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        print(f"main path: {time.perf_counter() - t0:.1f} s, launches {launches}")
    require_launched("CKKS main path", launches, ("ntt_fwd", "ntt_inv", "keyswitch2_fused"))
    if not np.isfinite(dec).all() or dec.shape != (N // 2,):
        raise AssertionError("decode gave non-finite values or the wrong shape")
    for t in (out.c, res.c, res1.c):
        if int(t.min()) < 0 or int(t.max()) >= 1 << 30:
            raise AssertionError("residues out of range")
    dec_err = float(np.abs(dec - z * z[::-1]).max())
    dec1_err = float(np.abs(dec1 - (z * z[::-1]) ** 2).max())
    fresh_err = float(np.abs(ckks.decode(ctx, ckks.decrypt(ctx, sk, ct1)) - z).max())
    print(f"decode max abs error vs z*z[::-1]: {dec_err:.3e} (limit {TOL_DECODE}); "
          f"level-1 square: {dec1_err:.3e} (limit {TOL_DECODE_L1}); "
          f"fresh encrypt/decrypt of z: {fresh_err:.3e}")
    if not (dec_err <= TOL_DECODE and dec1_err <= TOL_DECODE_L1):
        raise AssertionError("decode error above the limit")

    # the same multiply -> relinearize -> rescale on the CPU (plain path)
    t0 = time.perf_counter()
    cctx = ckks.make_context(N, Q_BITS, ks_type="II", alpha=ALPHA, device="cpu")
    cpu = lambda c: ckks.Ciphertext(c.c.cpu(), c.size, c.level, c.scale)
    crk = ckks.KSKey(rk.k0.cpu(), rk.k1.cpu())
    c_relin = ckks.relinearize(cctx, ckks.multiply(cctx, cpu(ct1), cpu(ct2)), crk)
    c_res = ckks.rescale(cctx, c_relin)
    same = (torch.equal(c_relin.c, relin.c.cpu()) and torch.equal(c_res.c, res.c.cpu()))
    print(f"CPU plain path residues identical to the card's: {same} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("CPU and card residues differ")

    # -- 6. the rotation path ---------------------------------------------------
    rot_launches, rot, time_rotations = rotation_phase(ctx, cctx, sk, pk, card, errs)

    # -- 7. timings (CUDA events) ---------------------------------------------
    def chain():
        c = ct1
        for _ in range(K_CHAIN):
            c = ckks.relinearize(ctx, ckks.multiply(ctx, c, ct2), rk)
            c = ckks.Ciphertext(c.c, 2, 0, ctx.default_scale)
        return c

    chain_ms = cuda_ms(chain, reps=3, warm=1)
    ops_s = K_CHAIN / (chain_ms / 1e3)
    print(f"chain: K={K_CHAIN} mult+relin (through K5) in {chain_ms:.3f} ms -> "
          f"{ops_s:.3f} ops/s [{card}]")

    # K1 at the hoisting shapes of earlier records (the kernel record's ms), then at
    # the main path's: the INTT of c2 and the forward transform of both keyswitch
    # halves in a mult+relin or a rotate
    ntt_recs = {"ntt_fwd": [time_ntt(ctx.ntt_qp, 3, False), time_ntt(ctx.ntt_q(0), 2, False),
                            time_ntt(ctx.ntt_q(0), 1, False)],
                "ntt_inv": [time_ntt(ctx.ntt_qp, 2, True), time_ntt(ctx.ntt_q(0), 1, True)]}
    # K2 at the main path's shapes (mac_keys over 3 digits of 16 limbs, the 4 -> 16
    # conversion of hoisting, both forms) and K6 on a keyswitch's two halves
    # (2, 16, 2^16) -> (2, 12, 2^16)
    z4 = rand_residues(ctx.q_primes[:4], (4, N), gen, dev)
    bq = ctx.base_qp
    chain = ctx.ks2[0].div_stages
    x16 = rand_residues(list(ctx.qp_primes) * 2, (32, N), gen, dev).view(2, 16, N)
    shapes = {"mac_keys": (lambda: rns.mac_keys_cuda(d, k0, k1, bq),
                           lambda: mac_keys_plain(d, k0, k1, bq), "(3, 16, 2^16)",
                           bound(nbytes(d, k0, k1, d[:2], bq.p, bq.pinv, bq.mu),
                                 2 * d.numel() * MAC_OPS + 2 * 16 * N * FOLD_OPS))}
    shapes.update(conv_shapes(ctx.ks2[0].convs[0], z4))
    shapes.update(div_shapes(chain, x16, "keyswitch"))
    k2k6 = time_kernels(shapes, "the main path's", N, card, errs)
    times = {k: (r[0]["ms"], r[0]["plain_ms"]) for k, r in ntt_recs.items()}
    bounds = {k: (r[0]["bound_ms"], r[0]["bound_by"]) for k, r in ntt_recs.items()}
    for name, label in (("mac_keys", "mac_keys"), ("base_conv", "base_conv 4->16 B=1 scaled"),
                        ("div_round", "div_round keyswitch")):
        r = k2k6[label]
        times[name], bounds[name] = (r["ms"], r["plain_ms"]), (r["bound_ms"], r["bound_by"])
    # K5 at levels 0 and 1, each beside the staged route on the same inputs (held
    # equal first), in turns: staged, kernel, kernel, staged
    ks_levels = {}
    for level in (0, 1):
        fargs = fused_inputs(ctx, level, gen)
        kern = lambda: ksf.keyswitch2_fused_cuda(*fargs)
        route = lambda: staged_route(ctx, level, fargs)
        e = max(max_err(kern(), route()), max_err(route(), ksf.keyswitch2_fused_core_plain(*fargs)))
        torch.cuda.synchronize()
        errs["keyswitch2_fused"] = max(errs["keyswitch2_fused"], e)
        if e:
            raise AssertionError(f"K5, the staged route and the plain core disagree at level {level}")
        s_ms = [cuda_ms(route, reps=20)]
        k_ms = [cuda_ms(kern, reps=20), cuda_ms(kern, reps=20)]
        s_ms.append(cuda_ms(route, reps=20))
        ms, sms = sum(k_ms) / 2, sum(s_ms) / 2
        pms = cuda_ms(lambda: ksf.keyswitch2_fused_core_plain(*fargs), reps=3)
        bnd = keyswitch_bound(fargs)
        # the device time alone (torch.profiler): events around back-to-back calls read
        # the host's launch rate where the host is the slower
        dev_ms = traced_device_ms(kern, 10)[0]
        ks_levels[level] = {"ms": ms, "staged_ms": sms, "ratio_to_staged": ms / sms,
                            "plain_ms": pms, "bound_ms": bnd[0], "bound_by": bnd[1],
                            "device_ms": dev_ms, "kernel_runs_ms": k_ms,
                            "staged_runs_ms": s_ms}
        print(f"time keyswitch2_fused level {level} (z {tuple(fargs[0].shape)}, "
              f"{len(fargs[5])} digits, {fargs[4].num_limbs} limbs): kernel {ms:.4f} ms "
              f"({k_ms[0]:.4f}, {k_ms[1]:.4f}), staged route (base_conv per digit + ntt_fwd + "
              f"mac_keys + ntt_inv) {sms:.4f} ms ({s_ms[0]:.4f}, {s_ms[1]:.4f}), ratio "
              f"{ms / sms:.4f}; device {fmt_ms(dev_ms)} ms; plain {pms:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}) [{card}]")
    times["keyswitch2_fused"] = (ks_levels[0]["ms"], ks_levels[0]["plain_ms"])
    bounds["keyswitch2_fused"] = (ks_levels[0]["bound_ms"], ks_levels[0]["bound_by"])
    ckks_prof = {}
    print_profile("CKKS mult+relin", lambda: ckks.relinearize(ctx, ckks.multiply(ctx, ct1, ct2), rk),
                  5, card, ckks_prof, "mult_relin")
    rot.update(time_rotations())

    # -- 8-10. the TFHE path ------------------------------------------------------
    tfhe_launches, tfhe_times, tfhe_bounds, tfhe_tim, per_step, tfhe_ntt = tfhe_phases(
        dev, card, check_ntt, time_ntt, errs)
    for name, recs in tfhe_ntt.items():
        ntt_recs[name] += recs

    # -- 11-13. bootstrapping --------------------------------------------------------
    boot_launches, boot_rec = bootstrap_phases(dev, card, errs, gen)
    # -- 14. the bootstrapping variants -----------------------------------------------
    v2_launches, v2_rec = bootstrap_v2_phases(dev, card, errs)
    # -- 15. BFV ----------------------------------------------------------------------
    bfv_launches, bfv_rec, bfv_ntt = bfv_phases(dev, card, errs, time_ntt, gen)
    for name, recs in bfv_ntt.items():
        ntt_recs[name] += recs
    # -- 16. CKKS with Method-I keyswitching ------------------------------------------
    m1_launches, m1_rec = ckks_method1_phase(dev, card, errs)
    # -- 17. BGV ------------------------------------------------------------------------
    bgv_launches, bgv_rec, bgv_kern = bgv_phases(dev, card, errs, gen)
    # -- 18. MPC ------------------------------------------------------------------------
    mpc_launches, mpc_rec, mpc_kern = mpc_phases(dev, card, errs)
    # -- 19. the parallel layer ------------------------------------------------------------
    par_launches, par_rec, par_kern = parallel_phases(dev, card, errs, gen, ctx, rk)
    # -- 20. the host utilities, the native engine and the limb-sharded CKKS step ----------
    t20 = time.perf_counter()
    util_rec = utilities_phase(card, ctx, rk, ct1, ct2)
    native_rec = native_phase(card)
    sh_launches, sh_rec = ckks_sharded_phase(dev, card, errs, gen, ctx, rk, ct1, ct2)
    print(f"phase 20: {time.perf_counter() - t20:.1f} s")
    # -- 21. the limb-sharded bootstrap -------------------------------------------------------
    t21 = time.perf_counter()
    bsh_launches, bsh_rec = boot_sharded_phase(dev, card, errs, boot_rec.pop("out_c"), boot_rec)
    print(f"phase 21: {time.perf_counter() - t21:.1f} s")
    # -- 22. the bootstrapping variants on limb-sharded ciphertexts ------------------------
    t22 = time.perf_counter()
    bv2_launches, bv2_rec = boot_v2_sharded_phase(dev, card, errs, v2_rec.pop("sharded_refs"),
                                                  v2_rec)
    print(f"phase 22: {time.perf_counter() - t22:.1f} s")
    # -- 23. stripped keys on the sharded paths, the reference's key sets in the loader --
    t23 = time.perf_counter()
    st_launches, st_rec = stripped_phase(dev, card, errs, ctx, sk)
    print(f"phase 23: {time.perf_counter() - t23:.1f} s")
    # each kernel's launches on the fifteen paths, each run counted from 0 just before it
    ckks_launches = launches
    launches = {k: ckks_launches[k] + rot_launches[k] + tfhe_launches[k] + boot_launches[k]
                + v2_launches[k] + bfv_launches[k] + m1_launches[k] + bgv_launches[k]
                + mpc_launches[k] + par_launches[k] + sh_launches[k] + bsh_launches[k]
                + bv2_launches[k] + st_launches[k] for k in launches}
    # K6's t-exact mode at BGV's keyswitch shape, K7 at the depth-48 bootstrap key's, its
    # raw-words mode at MPC BFV's widest draw (a relin round's gaussian, (29, 2^15))
    k7_kern = boot_rec["compressed"]["kernels"]
    for name, r in (("div_exact_t", bgv_kern["div_exact_t keyswitch"]),
                    ("threefry_uniform", next(iter(k7_kern.values()))),
                    ("threefry_bits", next(iter(mpc_kern.values()))),
                    ("ntt_pass", par_kern[PAR_MAIN_PASS])):
        times[name], bounds[name] = (r["ms"], r["plain_ms"]), (r["bound_ms"], r["bound_by"])
    times.update(tfhe_times)
    bounds.update(tfhe_bounds)

    sources = {"ntt_fwd": ("heongpu_tpu_torch/kernels/csrc/ntt.cu",
                           "heongpu_tpu/ops/ntt_pallas.py:187"),
               "ntt_inv": ("heongpu_tpu_torch/kernels/csrc/ntt.cu",
                           "heongpu_tpu/ops/ntt_pallas.py:187"),
               "mac_keys": ("heongpu_tpu_torch/kernels/csrc/mac.cu",
                            "heongpu_tpu/ops/rns.py:123"),
               "base_conv": ("heongpu_tpu_torch/kernels/csrc/mac.cu",
                             "heongpu_tpu/ops/rns.py:199"),
               "blind_rotate": ("heongpu_tpu_torch/kernels/csrc/tfhe.cu",
                                "heongpu_tpu/ops/tfhe_kernel.py:558"),
               "blind_rotate2": ("heongpu_tpu_torch/kernels/csrc/tfhe.cu",
                                 "heongpu_tpu/ops/tfhe_kernel.py:572"),
               "div_round": ("heongpu_tpu_torch/kernels/csrc/divround.cu",
                             "heongpu_tpu/ops/rns.py:226"),
               "div_exact_t": ("heongpu_tpu_torch/kernels/csrc/divround.cu",
                               "heongpu_tpu/models/bgv.py:54"),
               "threefry_uniform": ("heongpu_tpu_torch/kernels/csrc/threefry.cu",
                                    "heongpu_tpu/utils/rng.py:127"),
               "threefry_bits": ("heongpu_tpu_torch/kernels/csrc/threefry.cu",
                                 "heongpu_tpu/utils/rng.py:84"),
               "ntt_pass": ("heongpu_tpu_torch/kernels/csrc/ntt.cu",
                            "heongpu_tpu/parallel/ntt_sharded.py:78"),
               "keyswitch2_fused": ("heongpu_tpu_torch/kernels/csrc/keyswitch.cu",
                                    "heongpu_tpu/ops/keyswitch_pallas.py:148")}
    kernels_rec = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name, (src, rep) in sources.items()]
    kernels_rec[-1].update(staged_ms=ks_levels[0]["staged_ms"],
                           ratio_to_staged=ks_levels[0]["ratio_to_staged"],
                           device_ms=ks_levels[0]["device_ms"], level1=ks_levels[1])
    # K2 and K6: the device time at the main path's shape, and every timed shape
    boot_full = [r for k, r in boot_rec.items() if k != "compressed"][-1]
    boot_z, v2_full = boot_rec["compressed"], list(v2_rec.values())[-1]
    bfv_default = next(r for k, r in bfv_rec.items() if k.endswith("_default"))
    # every timed shape under its phase's name: the phases time a kernel under
    # the same labels
    k_shapes = {f"{phase}: {lbl}": (lbl.split()[0], r)
                for phase, recs in (("main", k2k6), ("bootstrap", boot_full["kernels"]),
                                    ("bfv", bfv_default["kernels"]), ("bgv", bgv_kern),
                                    ("compressed bootstrap", k7_kern), ("mpc", mpc_kern),
                                    ("parallel", par_kern), ("stripped keys", st_rec["kernels"]))
                for lbl, r in recs.items()}
    main_label = {"mac_keys": ("main", "mac_keys"),
                  "base_conv": ("main", "base_conv 4->16 B=1 scaled"),
                  "div_round": ("main", "div_round keyswitch"),
                  "div_exact_t": ("bgv", "div_exact_t keyswitch"),
                  "threefry_uniform": ("compressed bootstrap", next(iter(k7_kern))),
                  "threefry_bits": ("mpc", next(iter(mpc_kern))),
                  "ntt_pass": ("parallel", PAR_MAIN_PASS)}
    for k in kernels_rec:
        if k["name"] in main_label:
            k.update(device_ms=k_shapes[": ".join(main_label[k["name"]])][1]["device_ms"],
                     shapes={lbl: r for lbl, (name, r) in k_shapes.items() if name == k["name"]})
        if k["name"] in ntt_recs:
            first = ntt_recs[k["name"]][0]
            k.update(device_ms=first["device_ms"], passes=first["passes"],
                     shapes=ntt_recs[k["name"]][1:])
        k.update(per_step.get(k["name"], {}))
        if k["name"] in ptxas:
            k["ptxas"] = ptxas[k["name"]]
    bad = [k["name"] for k in kernels_rec if not k["launches"] or k["max_abs_err"]]
    if bad:
        raise AssertionError(f"kernels not launched on their path or in error: {bad}")
    record = {"kernels": kernels_rec,
              "chain_ops_per_s": ops_s, "decode_max_abs_err": dec_err,
              "level1_decode_max_abs_err": dec1_err, "fresh_decode_max_abs_err": fresh_err,
              "ckks": ckks_prof, "rotation_launches": rot_launches, "rotation": rot,
              "tfhe_launches": tfhe_launches, "tfhe": tfhe_tim,
              "bootstrap_launches": boot_launches, "bootstrap": boot_rec,
              "bootstrap_v2_launches": v2_launches, "bootstrap_v2": v2_rec,
              "bfv_launches": bfv_launches, "bfv": bfv_rec,
              "ckks_method1_launches": m1_launches, "ckks_method1": m1_rec,
              "bgv_launches": bgv_launches, "bgv": bgv_rec,
              "mpc_launches": mpc_launches, "mpc": mpc_rec,
              "parallel_launches": par_launches, "parallel": par_rec,
              "utilities": util_rec, "native": native_rec,
              "ckks_sharded_launches": sh_launches, "ckks_sharded": sh_rec,
              "boot_sharded_launches": bsh_launches, "boot_sharded": bsh_rec,
              "boot_v2_sharded_launches": bv2_launches, "boot_v2_sharded": bv2_rec,
              "stripped_launches": st_launches, "stripped": st_rec,
              "div_round_runs": DIV_ROUND_RUNS}
    busy = {"CKKS mult+relin (Method II)": ckks_prof,
            "CKKS mult+relin, Method I": m1_rec["profile"],
            "BFV mult+relin, default chain": bfv_default["profile"],
            "BGV mult+relin+mod_switch": list(bgv_rec.values())[-1]["profile"]}
    print("device busy ms / idle share: " + "; ".join(
        f"{what} {fmt_ms(prof['mult_relin_busy_ms'])} / {fmt_ms(prof['mult_relin_idle_share'])}"
        for what, prof in busy.items())
        + f"; bootstrap depth 48 {fmt_ms(boot_full['profile']['bootstrap_busy_ms'])} / "
        f"{fmt_ms(boot_full['profile']['bootstrap_idle_share'])}, compressed keys "
        f"{fmt_ms(boot_z['profile']['bootstrap_busy_ms'])} / "
        f"{fmt_ms(boot_z['profile']['bootstrap_idle_share'])}; regular v2 "
        f"{fmt_ms(v2_full['regular']['profile']['run_busy_ms'])} / "
        f"{fmt_ms(v2_full['regular']['profile']['run_idle_share'])}; MPC threshold decryption "
        f"BFV {fmt_ms(mpc_rec['bfv']['profile']['threshold_decrypt_busy_ms'])} / "
        f"{fmt_ms(mpc_rec['bfv']['profile']['threshold_decrypt_idle_share'])}, CKKS "
        f"{fmt_ms(mpc_rec['ckks']['profile']['threshold_decrypt_busy_ms'])} / "
        f"{fmt_ms(mpc_rec['ckks']['profile']['threshold_decrypt_idle_share'])}; collective "
        f"bootstrap BFV {fmt_ms(mpc_rec['bfv']['profile']['colboot_busy_ms'])} / "
        f"{fmt_ms(mpc_rec['bfv']['profile']['colboot_idle_share'])}, CKKS "
        f"{fmt_ms(mpc_rec['ckks']['profile']['colboot_busy_ms'])} / "
        f"{fmt_ms(mpc_rec['ckks']['profile']['colboot_idle_share'])} [{card}]")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
