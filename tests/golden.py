"""Golden CLI bytes captured from the reference binary (verified build,
SURVEY.md §4.2), shared by tests/test_cli.py and chip_smoke.py."""

README_INPUT = b"GCATGCU GATTACA"

# `-s 1 1 1` on the README pair: every optimal alignment (stdout) and
# the summary (stderr)
README_ALIGNMENTS = (
    b"GCA-TGCU\nG-ATTACA\n\n"
    b"GCAT-GCU\nG-ATTACA\n\n"
    b"GCATG-CU\nG-ATTACA\n\n"
)
README_SUMMARY = b"3 optimal alignments\nOptimal score is 0\n"

# `-t 1 1 1` on the README pair: the scores table (after the blank line
# that separates it from earlier output)
README_TABLE = (
    b"\n"
    b"*     -     G     C     A     T     G     C     U\n"
    b"                                                 \n"
    b"-    +0  < -1  < -2  < -3  < -4  < -5  < -6  < -7\n"
    b"      ^  \\                       \\               \n"
    b"G    -1    +1  < +0  < -1  < -2  < -3  < -4  < -5\n"
    b"      ^     ^  \\     \\                           \n"
    b"A    -2    +0    +0    +1  < +0  < -1  < -2  < -3\n"
    b"      ^     ^  \\  ^     ^  \\                     \n"
    b"T    -3    -1    -1    +0    +2  < +1  < +0  < -1\n"
    b"      ^     ^  \\  ^     ^  \\  ^  \\     \\     \\   \n"
    b"T    -4    -2    -2    -1    +1    +1  < +0  < -1\n"
    b"      ^     ^  \\  ^  \\        ^  \\  ^  \\     \\   \n"
    b"A    -5    -3    -3    -1    +0    +0    +0  < -1\n"
    b"      ^     ^  \\        ^     ^  \\  ^  \\         \n"
    b"C    -6    -4    -2    -2    -1    -1    +1  < +0\n"
    b"      ^     ^     ^  \\        ^  \\  ^     ^  \\   \n"
    b"A    -7    -5    -3    -1  < -2    -2    +0    +0\n"
)

# `-l 1 1 1` on "GT GA"
GT_GA_COUNTS = b"GT\nGA\n1 match, 1 mismatch, 0 indels\n\n"
