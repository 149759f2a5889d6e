"""Seconds the database build took: the benchmark's span around the call
that builds it (the program's database build; in a Runner cell the
Runner's construction, which reads the FASTA and builds it)."""


def read(facts, cell):
    s = facts["spans"].seconds("db_build")
    return s[0] if s else None
