"""CLI with byte-parity to the reference ``needleman-wunsch`` binary.

Implements the exact flag surface, stdout/stderr split, error messages,
and exit codes of the reference ``main()`` (needleman-wunsch.c:698-795),
including its quirks:

* ``-h`` prints usage to stderr and exits **1** (usage(), :65-89);
* operands are parsed with C ``atoi`` semantics — garbage silently
  becomes 0 (:783-785);
* ``log_err`` appends ``strerror(errno)``; with errno == 0 the reference
  prints the literal bytes ``\\b\\b \\b`` ("erase the colon" hack,
  dbg.h:61) — reproduced verbatim;
* glibc ``getopt`` messages use the *raw* argv[0], while ``log_err`` uses
  argv[0] with only a leading ``./`` stripped (dbg.c:7-15);
* the ``-s`` summary goes to stderr (computation.c:277-280).

The compute path runs on the accelerator: anti-diagonal scan fill on
device, O(M*N) path counting/marking, host (native C++) enumeration only
when alignment strings must be printed.
"""

from __future__ import annotations

import getopt
import os
import sys
from typing import BinaryIO, List, Optional

USAGE = b"""\
usage: needleman-wunsch [-c][-h][-l][-q][-s][-t][-u]
                        [-p num-threads] [-f sequence-file] m k d
Align two sequences with the Needleman-Wunsch algorithm
operands:
   m   match bonus
   k   mismatch penalty
   d   indel (gap) penalty
options:
  -c   color the output with ANSI escape sequences
  -f sequence-file
       read the input strings from 'sequence-file' instead of standard input
  -h   print this usage message
  -l   list match, mismatch, and indel counts for each alignment pair
  -p num-threads
       parallelize the computation with 'num-threads' threads (must be >1)
  -q   be quiet and don't print the aligned strings
  -s   summarize the algorithm's run
  -t   print the scores table; only useful for shorter input strings
  -u   use unicode arrows when printing the scores table
"""

# clean_errno() with errno == 0 (dbg.h:61): backspaces that "erase" the
# colon on a terminal; in a pipe they are literal bytes.
ERRNO_CLEAN = b"\x08\x08 \x08"


class _Exit(Exception):
    def __init__(self, code: int):
        self.code = code


class _FdStream:
    """Minimal raw-fd stream: read errors surface at read() time, like
    a stdio FILE over the same fd (fopen succeeds on a directory; the
    first fgetc sets ferror with EISDIR)."""

    def __init__(self, fd: int):
        self._fd = fd

    def fileno(self) -> int:
        return self._fd

    def read(self, n: int) -> bytes:
        return os.read(self._fd, n)

    def close(self) -> None:
        os.close(self._fd)


def _prog_name(argv0: str) -> str:
    """set_prog_name (dbg.c:7-15): strip only a leading './'."""
    return argv0[2:] if argv0.startswith("./") else argv0


def _log_err(stderr: BinaryIO, prog: str, msg: str, errno_str: Optional[bytes] = None):
    """log_err macro, NDEBUG form (dbg.h:67-71)."""
    tail = ERRNO_CLEAN if errno_str is None else errno_str
    stderr.write(prog.encode() + b": error: " + msg.encode() + b": " + tail + b"\n")


def _usage(stderr: BinaryIO):
    stderr.write(USAGE)
    raise _Exit(1)


def main(
    argv: List[str],
    stdin: Optional[BinaryIO] = None,
    stdout: Optional[BinaryIO] = None,
    stderr: Optional[BinaryIO] = None,
) -> int:
    stdin = stdin if stdin is not None else sys.stdin.buffer
    stdout = stdout if stdout is not None else sys.stdout.buffer
    stderr = stderr if stderr is not None else sys.stderr.buffer
    try:
        _run(argv, stdin, stdout, stderr)
        return 0
    except _Exit as e:
        return e.code
    finally:
        try:
            stdout.flush()
        except Exception:
            pass
        try:
            stderr.flush()
        except Exception:
            pass


def _run(argv: List[str], stdin: BinaryIO, stdout: BinaryIO, stderr: BinaryIO):
    from nw_tpu.utils.textio import EarlyEOFError, c_atoi, read_two_sequences

    argv0_raw = argv[0] if argv else "needleman-wunsch"
    prog = _prog_name(argv0_raw)

    try:
        opts, operands = getopt.gnu_getopt(argv[1:], "cf:hlp:qstu")
    except getopt.GetoptError as e:
        # glibc getopt error messages use the raw argv[0]
        opt = (e.opt or "?")[:1]
        if "requires argument" in e.msg:
            stderr.write(
                argv0_raw.encode() + b": option requires an argument -- '"
                + opt.encode() + b"'\n"
            )
        else:
            stderr.write(
                argv0_raw.encode() + b": invalid option -- '" + opt.encode() + b"'\n"
            )
        _usage(stderr)

    cflag = lflag = qflag = sflag = tflag = uflag = 0
    infile_path: Optional[str] = None
    num_threads = 1
    for opt, val in opts:
        if opt == "-c":
            cflag = 1
        elif opt == "-f":
            infile_path = val
        elif opt == "-h":
            _usage(stderr)
        elif opt == "-l":
            lflag = 1
        elif opt == "-p":
            num_threads = c_atoi(val)
            if num_threads <= 1:
                _log_err(
                    stderr,
                    prog,
                    f"num-threads == {num_threads}; num-threads "
                    "must be greater than 1",
                )
                raise _Exit(1)
        elif opt == "-q":
            qflag = 1
        elif opt == "-s":
            sflag = 1
        elif opt == "-t":
            tflag = 1
        elif opt == "-u":
            uflag = 1

    if len(operands) != 3:
        n = len(operands)
        only = "" if (n > 3 or n == 0) else " only"
        _log_err(stderr, prog, f"expected 3 operands but received{only} {n}")
        _usage(stderr)

    if infile_path is None:
        infile = stdin
    else:
        # fopen(path, "r") only open(2)s — it SUCCEEDS on a directory
        # (needleman-wunsch.c:776-777); the failure surfaces at the
        # first fgetc as a stream error.  Mirror that by opening the
        # raw fd (no Python io validation) and deferring the error to
        # the read loop below.
        try:
            infile = _FdStream(os.open(infile_path, os.O_RDONLY))
        except OSError as e:
            _log_err(
                stderr,
                prog,
                f"failed to open {infile_path}",
                (e.strerror or "").encode(),
            )
            raise _Exit(1)

    try:
        s1, s2 = read_two_sequences(infile)
    except EarlyEOFError:
        _log_err(stderr, prog, "got EOF too early when reading input strings")
        raise _Exit(1)
    except OSError as e:
        # ferror() is checked BEFORE feof() (read-sequences.c:46-55):
        # any read(2) failure — e.g. EISDIR for `-f <directory>` — dies
        # as "fgetc failed: <strerror>", even where EOF would be legal.
        _log_err(stderr, prog, "fgetc failed", (e.strerror or "").encode())
        raise _Exit(1)

    # The reference reads raw bytes up to whitespace but then treats the
    # buffers as C strings everywhere (strlen at computation.c:158-160,
    # %s prints): an embedded NUL truncates the sequence, while the
    # reader still consumed the bytes after it from the stream.
    s1 = s1.split(b"\x00")[0]
    s2 = s2.split(b"\x00")[0]

    m = c_atoi(operands[0])
    k = c_atoi(operands[1])
    d = c_atoi(operands[2])

    # num_threads has no effect on release output in the reference
    # (single- vs multi-threaded scoring is bit-identical); it only
    # shapes the debug build's spawn/join traces.
    _needleman_wunsch(s1, s2, m, k, d, cflag, lflag, qflag, sflag, tflag, uflag,
                      stdout, stderr, prog=prog, num_threads=num_threads)


def _needleman_wunsch(
    s1: bytes, s2: bytes, m: int, k: int, d: int,
    cflag: int, lflag: int, qflag: int, sflag: int, tflag: int, uflag: int,
    stdout: BinaryIO, stderr: BinaryIO,
    prog: str = "needleman-wunsch", num_threads: int = 1,
):
    """The algorithm driver — mirrors needleman_wunsch()
    (needleman-wunsch.c:654-689).

    With ``NW_TPU_DEBUG=1`` the stderr trace of the reference's DEBUG
    build (``make debug``: dbg.h:53-57 ``debug()`` lines incl. the
    walk-table branch count, needleman-wunsch.c:624-625) is reproduced
    byte-for-byte.
    """
    import numpy as np

    from nw_tpu.ops import encode as enc
    from nw_tpu.ops import enumerate_walk, pathcount
    from nw_tpu.ops.fill_scan import diag_to_matrix, fill_diag
    from nw_tpu.utils.alignout import format_aligned_pair

    len1, len2 = len(s1), len(s2)

    debug_mode = bool(os.environ.get("NW_TPU_DEBUG"))

    def dbg(where: str, msg: str) -> None:
        # debug() macro expansion (dbg.h:53-57)
        if debug_mode:
            stderr.write(f"{prog}: debug: {where}: {msg}\n".encode())

    # alloc/init traces (computation.c:54, :159-168)
    dbg("computation.c:54", "Allocating for computation instance")
    dbg("computation.c:159", f"Top string is {len1} characters long")
    dbg("computation.c:161", f"Side string is {len2} characters long")
    dbg("computation.c:164", "Allocating score table")
    dbg("computation.c:166", "Allocating walk table")
    dbg("computation.c:168", "Initializing score and walk tables")

    # Pad to power-of-two buckets so repeated CLI invocations with
    # different input lengths reuse compiled fills (pad regions never
    # contaminate the true rectangle; everything downstream slices or
    # indexes by the true lengths).
    def _bucket(n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return b

    top = enc.pad_to(enc.encode(s1), _bucket(len1), enc.PAD_TOP)
    side = enc.pad_to(enc.encode(s2), _bucket(len2), enc.PAD_SIDE)

    solution_count = 0  # uint32 semantics applied at print time
    need_walk = qflag != 1 or lflag == 1 or sflag == 1 or tflag == 1
    printing = qflag != 1 or lflag == 1

    # Huge-pair fast path: when only the score (and count, -s) are
    # observable, a single O(N)-memory pass with the count DP riding the
    # score wavefront replaces the full table fill — the reference at
    # this scale needs 136 B/cell of RAM (13.6 GB at 10k x 10k,
    # SURVEY.md §6) and we would need the full arrow table.  Output is
    # byte-identical.
    huge_cells = int(os.environ.get("NW_TPU_HUGE_CELLS", str(1 << 28)))
    if (
        (len1 + 1) * (len2 + 1) > huge_cells
        and not printing
        and tflag != 1
        and not debug_mode  # branch-count trace needs the arrow table
    ):
        from nw_tpu.ops.fill_scan import fill_score_count

        sc, cnt = fill_score_count(top, side, m, k, d, len1, len2)
        score = int(sc)
        if len1 == 0 and len2 == 0:
            solution_count = 0  # reference DFS emits nothing on 1x1
        elif need_walk:
            solution_count = int(cnt)
        if sflag == 1:
            u = solution_count % (2**32)
            signed = u - 2**32 if u >= 2**31 else u
            plural = b"s" if u > 1 else b""
            stderr.write(b"%d optimal alignment%s\n" % (signed, plural))
            stderr.write(b"Optimal score is %d\n" % score)
        return

    out = fill_diag(top, side, m, k, d, len1, len2, with_scores=True)
    arrows_diag = np.asarray(out["arrows"])
    score = int(out["score"])

    if debug_mode:
        # compute_table_scores traces (needleman-wunsch.c:595-625)
        tpl = "s" if num_threads > 1 else ""
        dbg(
            "needleman-wunsch.c:595",
            f"Spawning {num_threads} worker thread{tpl} for scores "
            "table computation",
        )
        for i in range(num_threads):
            dbg("needleman-wunsch.c:618", f"Joined thread {i + 1}")
        dbg(
            "needleman-wunsch.c:621",
            f"Joined {num_threads} worker thread{tpl}",
        )
        branches = (
            int(pathcount.count_branches(arrows_diag, len1, len2)) % (2**32)
        )
        # the message carries its own newline; the macro adds another
        dbg("needleman-wunsch.c:624", f"{branches} branches in walk table\n")

    if need_walk and debug_mode:
        dbg(
            "needleman-wunsch.c:367",
            "Allocated temporary solution printing strings X and Y.",
        )
        dbg("needleman-wunsch.c:226", "Starting alignment construction.")

    if need_walk:
        if printing:
            arrows_rect = diag_to_matrix(arrows_diag, len1, len2)

            def emit(X: bytes, Y: bytes):
                stdout.write(
                    format_aligned_pair(X, Y, bool(qflag), bool(lflag), bool(cflag))
                )

            solution_count = enumerate_walk.enumerate_alignments(
                arrows_rect, s1, s2, emit
            )
        else:
            # Only the count (and/or path marks) are observable: O(M*N)
            # dynamic programs replace the reference's exponential DFS
            # with identical output.
            if len1 == 0 and len2 == 0:
                solution_count = 0
            else:
                solution_count = int(pathcount.count_paths(arrows_diag, len1, len2))
        dbg("needleman-wunsch.c:330", "Finished alignment construction.")

    if sflag == 1:
        u = solution_count % (2**32)  # unsigned int counter (computation.h:65)
        signed = u - 2**32 if u >= 2**31 else u  # printed with %d
        plural = b"s" if u > 1 else b""
        stderr.write(b"%d optimal alignment%s\n" % (signed, plural))
        stderr.write(b"Optimal score is %d\n" % score)

    if tflag == 1:
        from nw_tpu.utils.render import render_table

        if qflag != 1 or sflag == 1 or lflag == 1:
            stdout.write(b"\n")
        scores_rect = diag_to_matrix(np.asarray(out["scores"]), len1, len2)
        arrows_rect = diag_to_matrix(arrows_diag, len1, len2)
        if len1 == 0 and len2 == 0:
            # 1x1 table: the reference DFS loop guard is false on entry
            # (needleman-wunsch.c:231-235) so nothing gets marked.
            in_path = np.zeros((1, 1), bool)
        else:
            marks_diag = np.asarray(pathcount.mark_optimal_cells(arrows_diag, len1, len2))
            in_path = diag_to_matrix(marks_diag, len1, len2).astype(bool)
        stdout.write(
            render_table(
                scores_rect, arrows_rect, in_path, s1, s2,
                unicode=bool(uflag), color=bool(cflag),
            )
        )


def apply_platform_override() -> None:
    """Honor NW_TPU_PLATFORM (e.g. ``cpu``, ``gpu``) in a console entry
    point: an explicit user choice of JAX backend, applied at the config
    level too so it holds even if jax was imported first.  Shared by
    every console script (nw-tpu, nw-tpu-batch)."""
    platform = os.environ.get("NW_TPU_PLATFORM")
    if platform:
        os.environ["JAX_PLATFORMS"] = platform
        import jax

        jax.config.update("jax_platforms", platform)


def console_main() -> None:
    _quiet_library_logging()
    stderr_io = _isolate_stderr_fd()
    apply_platform_override()
    enable_default_compile_cache()
    try:
        code = main(sys.argv, stderr=stderr_io)
    except BaseException:
        if stderr_io is not None and not isinstance(
            sys.exc_info()[1], (SystemExit, KeyboardInterrupt)
        ):
            # crashes must not vanish into the /dev/null'd fd 2
            import traceback

            stderr_io.write(traceback.format_exc().encode())
            sys.exit(1)
        raise
    sys.exit(code)


def _isolate_stderr_fd() -> Optional[BinaryIO]:
    """Hard stderr byte-parity guarantee: the reference binary writes
    NOTHING to stderr unprompted (its only release-mode stderr writes
    are the ``-s`` summary, computation.c:277-280, and error paths).
    XLA's C++ absl logging (e.g. cpu_aot_loader.cc machine-feature
    complaints when a persistent-cache AOT entry mismatches) writes to
    the raw fd 2 and ignores TF_CPP_MIN_LOG_LEVEL on some jaxlib
    builds, so env/logging suppression alone is not airtight.

    Fix at the fd level: keep a private dup of the real stderr for the
    CLI's own parity output, then point fd 2 itself at /dev/null so
    nothing any C++ library prints can reach the user.  Returns the
    stream the CLI must write parity stderr bytes to (None = use the
    process stderr unchanged, e.g. under NW_TPU_VERBOSE=1)."""
    if os.environ.get("NW_TPU_VERBOSE"):
        return None
    try:
        real_fd = os.dup(2)
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, 2)
        os.close(devnull)
    except OSError:
        return None
    return os.fdopen(real_fd, "wb", buffering=0)


def _quiet_library_logging() -> None:
    """Keep stderr byte-clean for parity: XLA's C++ logging (e.g. the
    AOT cache loader's machine-feature complaints) and jax's Python
    logger both write to the process stderr, which the reference binary
    never does.  NW_TPU_VERBOSE=1 restores the logs."""
    if os.environ.get("NW_TPU_VERBOSE"):
        return
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    import logging
    import warnings

    logging.getLogger("jax").setLevel(logging.CRITICAL)
    logging.getLogger("jax._src.xla_bridge").setLevel(logging.CRITICAL)
    # Python-level warnings (slow-compile notices, deprecations) also
    # land on stderr; under load they appear nondeterministically
    warnings.simplefilter("ignore")
    logging.getLogger().setLevel(logging.CRITICAL)


CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> Optional[str]:
    """Where the program puts JAX's persistent compile cache: None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (jax reads that variable itself
    and the program sets no other directory), else ``.jax_cache`` inside
    the checkout — one fixed path, so a rerun finds its entries."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_default_compile_cache() -> None:
    """Persistent compile cache: repeat runs with the same shape bucket
    skip the cold compile (the C reference has no compile step; this
    keeps warm-path latency comparable)."""
    import jax

    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
