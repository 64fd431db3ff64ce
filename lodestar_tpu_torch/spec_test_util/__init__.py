"""Spec-test harness: run ethereum/consensus-spec-tests vector directories.

Reference: packages/spec-test-util/src/single.ts:93
(describeDirectorySpecTest).
"""

from .runner import (  # noqa: F401
    SpecTestCase,
    collect_spec_test_cases,
    describe_directory_spec_test,
    load_spec_test_case,
    spec_tests_root,
)
